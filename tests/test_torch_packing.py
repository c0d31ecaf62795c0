"""The port's copy of the packing helpers gives exactly the JAX package's
bins, widths and arrays on seeded lengths."""

from __future__ import annotations

import numpy as np
import pytest

from intool_rag_tpu.models import packing as jpack
from intool_rag_tpu_torch.models import packing as tpack

CASES = {  # name -> (seed, number of texts, longest text, row width)
    "short-texts": (0, 40, 60, 512),
    "mixed": (1, 97, 500, 512),
    "wide-rows": (2, 64, 900, 2048),
    "one-text": (3, 1, 17, 512),
    "item-longer-than-the-width": (4, 12, 700, 256),
    "every-text-fills-a-row": (5, 9, 128, 128),
}


@pytest.mark.parametrize("name", CASES)
def test_packing_equals_jax(name):
    seed, n, longest, width = CASES[name]
    rng = np.random.default_rng(seed)
    lengths = [int(x) for x in rng.integers(2, longest + 1, size=n)]
    if name == "item-longer-than-the-width":
        assert max(lengths) > width
    if name == "every-text-fills-a-row":
        lengths = [width] * n
    rows = [[int(t) for t in rng.integers(4, 1000, size=length)] for length in lengths]
    jbins, tbins = jpack.pack_bins(lengths, width), tpack.pack_bins(lengths, width)
    assert tbins == jbins
    assert sorted(i for _, members in tbins for i in members) == list(range(n))
    assert all(used <= width for used, _ in tbins)
    w = tpack.shrink_width(tbins, width)
    assert w == jpack.shrink_width(jbins, width) and w % 128 == 0 and w <= width
    for start in range(0, len(tbins), 5):  # launch chunks, as the provider cuts them
        got = tpack.build_packed_arrays(rows, tbins[start : start + 5], w, 1)
        want = jpack.build_packed_arrays(rows, jbins[start : start + 5], w, 1)
        for g, e in zip(got, want):
            assert g.dtype == e.dtype
            np.testing.assert_array_equal(g, e)
        ids, seg, cls, idx = got
        assert cls.shape[1] % 4 == 0 and (seg[ids == 1] == 0).all()
        for j in range(ids.shape[0]):  # each segment holds its text, cut to the width
            for p in np.flatnonzero(idx[j] >= 0):
                text = rows[idx[j, p]][:w]
                np.testing.assert_array_equal(ids[j, seg[j] == p + 1], text)
                assert ids[j, cls[j, p]] == text[0]
