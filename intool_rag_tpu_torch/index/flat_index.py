"""Flat dense index over a ChunkStore (port of the flat branches of
``intool_rag_tpu/index/flat_index.py``).

``flat_plan`` picks the flat branch: the fused kernels (K1 over the
bf16/f32 store, K2 over an int8 mirror with ``DENSE_INT8``) when
``USE_PALLAS`` is on and the metric is ``cosine``/``ip``, else the blocked
scan of :func:`..ops.topk.flat_topk`. Scores are in the clamped-cosine
space. With ``INDEX_KIND`` = ``ivf``, ``ivf_residual``, ``segmented`` or
``bits`` a store of at least ``_IVF_MIN_ROWS`` rows searches through that
capacity tier; smaller stores search flat. ``ivf`` (``IVFFlatIndex``) and
``ivf_residual`` (``IVFResidualIndex``, ``IVF_RESIDUAL_BITS``) rebuild on
every store mutation; ``segmented`` (``SegmentedResidualIndex``) and
``bits`` (``IVFBitsIndex``) append only the new rows and rebuild when the
store object changes (a delete).

``SHARDED_SEARCH`` routes as in the JAX package: with two or more local
devices (every visible card for a store on the card), ``on``, or ``auto``
on a store of at least ``SHARDED_SEARCH_MIN_ROWS`` rows, shards the store
over them (:mod:`..parallel.sharded_search`) before any capacity tier is
considered; the placement is cached per store mutation. On one device
every setting searches on that device.
"""

from __future__ import annotations

import weakref

import torch

from ..config import get_config
from ..ops.flat_fused import choose_group_width, flat_topk_fused, flat_topk_fused_int8
from ..ops.topk import clamp_cosine, flat_topk, rescore_candidates
from ..parallel import mesh
from .chunk_store import ChunkStore


def dense_dispatch(
    query_embeddings: torch.Tensor,
    arrays: tuple,
    *,
    kind: str,
    k: int,
    metric: str,
    valid_n: int,
    group_l: int = 32,
    precise: bool = True,
    block_n: int = 0,
    rescore: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense top-k for the flat branches (kind and statics from
    :meth:`DenseFlatIndex.flat_plan`); corpus data arrives in ``arrays``."""
    if kind == "fused_int8":
        q8, s8, res = arrays
        vals, rows = flat_topk_fused_int8(
            query_embeddings, q8, s8, k, corpus_res=res, group_l=group_l, valid_n=valid_n,
            tail="fold",
        )
    elif kind == "fused":
        (corpus,) = arrays
        vals, rows = flat_topk_fused(
            query_embeddings, corpus, k, group_l=group_l, valid_n=valid_n, precise=precise,
            tail="fold",
        )
    elif kind == "scan":
        (corpus,) = arrays
        vals, rows = flat_topk(
            query_embeddings, corpus, k, metric=metric, block_n=block_n, valid_n=valid_n
        )
    else:
        raise ValueError(f"unknown dense kind {kind!r}")
    if rescore:
        (corpus,) = arrays
        rescored = rescore_candidates(query_embeddings, corpus, rows, metric=metric)
        vals, order = torch.sort(rescored, dim=1, descending=True, stable=True)
        rows = torch.gather(rows, 1, order)
    if metric == "cosine":
        vals = clamp_cosine(vals)
    return vals, rows


class DenseFlatIndex:
    """Dense search over the store's embedding matrix."""

    # below this the IVF kinds search flat: too few rows per list to train
    _IVF_MIN_ROWS = 4096

    def __init__(self, store: ChunkStore, metric: str = "cosine") -> None:
        self.store = store
        self.metric = metric
        self._ivf = None  # the capacity-tier index, built on first routed search
        self._ivf_built_at = -1
        self._ivf_store_ref = None
        self._q8 = None  # (codes int8, scales f32, residual | None) for DENSE_INT8
        self._q8_built_at = -1
        self._sharded = None  # (mesh, payload): the store's placement over the devices
        self._sharded_built_at = -1

    def _use_sharded(self, cfg) -> bool:
        if cfg.SHARDED_SEARCH == "off" or self.metric not in ("cosine", "ip"):
            return False
        if len(mesh.local_devices(self.store.device.type)) < 2:
            return False
        if cfg.SHARDED_SEARCH == "on":
            return True
        return self.store.valid_n >= cfg.SHARDED_SEARCH_MIN_ROWS

    def _sharded_corpus(self):
        """``(mesh, payload)``, rebuilt per store mutation. Payload is
        ``("plain", store rows)`` or, with ``DENSE_INT8`` on the card,
        ``("int8", codes, scales, residual | None)`` of the int8 mirror.
        On the card each shard is padded to the widest kernel block
        (128·32 rows); padding rows are masked by valid_n before selection."""
        from ..parallel.sharded_search import shard_corpus

        cfg = get_config()
        on_card = self.store.device.type == "cuda"
        want_int8 = bool(cfg.DENSE_INT8) and on_card and cfg.USE_PALLAS
        if (
            self._sharded is None
            or self._sharded_built_at != self.store.mutation_count
            or (self._sharded[1][0] == "int8") != want_int8
        ):
            m = mesh.corpus_mesh(mesh.local_devices(self.store.device.type))
            row_align = 4096 if on_card and cfg.USE_PALLAS else 1
            if want_int8:
                q8, s8, res = self._int8_mirror(residual=cfg.DENSE_INT8_RESIDUAL)
                payload = (
                    "int8", shard_corpus(q8, m, row_align=row_align), shard_corpus(s8, m, row_align=row_align),
                    shard_corpus(res, m, row_align=row_align) if cfg.DENSE_INT8_RESIDUAL else None,
                )
            else:
                payload = ("plain", shard_corpus(self.store.embeddings, m, row_align=row_align))
            self._sharded = (m, payload)
            self._sharded_built_at = self.store.mutation_count
        return self._sharded

    def _sharded_search(self, query_embeddings: torch.Tensor, k: int, cfg):
        from ..parallel.sharded_search import kernel_group_l, sharded_flat_topk, sharded_flat_topk_int8

        store = self.store
        m, payload = self._sharded_corpus()
        if payload[0] == "int8":
            _, codes, scales, res = payload
            vals, rows = sharded_flat_topk_int8(query_embeddings, codes, scales, k, m, res=res,
                                                valid_n=store.valid_n)
        else:
            sharded = payload[1]
            shard_rows = max(sharded.shard_rows, 1)
            fused = cfg.USE_PALLAS and store.device.type == "cuda" and kernel_group_l(shard_rows, k) is not None
            vals, rows = sharded_flat_topk(
                query_embeddings, sharded, k, m, valid_n=store.valid_n,
                block_n=min(cfg.SEARCH_BLOCK_N, shard_rows), kernel="fused" if fused else "scan",
            )
        if self.metric == "cosine":
            vals = clamp_cosine(vals)
        return vals.to(store.device), rows.to(store.device)

    def _int8_mirror(self, residual: bool = False):
        """int8 + scales mirror of the store for K2, quantized on the
        store's device and cached per store mutation."""
        if (
            self._q8 is None
            or self._q8_built_at != self.store.mutation_count
            or (residual and self._q8[2] is None)
        ):
            from ..ops.quant import quantize_int8, quantize_int8_residual

            if residual:
                q8, res, s8 = quantize_int8_residual(self.store.embeddings)
            else:
                (q8, s8), res = quantize_int8(self.store.embeddings), None
            self._q8 = (q8, s8, res)
            self._q8_built_at = self.store.mutation_count
        return self._q8

    def _bits_index(self):
        """Capacity tier (INDEX_KIND=bits): list-major binary-residual
        store with streaming appends. Only the NEW rows are appended on a
        store mutation; a rebuild (fresh k-means, capacity 4× the current
        rows) happens only when the store object changes or the fixed
        capacity is outgrown."""
        from .bits_index import IVFBitsIndex

        cfg = get_config()
        store = self.store
        need = store.valid_n
        fresh = (
            not isinstance(self._ivf, IVFBitsIndex)
            or self._ivf_store_ref is None
            or self._ivf_store_ref() is not store
            or self._ivf.total_rows > need
            or need > self._ivf.n_cap - self._ivf.nlist  # spill headroom
        )
        if fresh:
            sample = store.embeddings[: min(need, 8 * cfg.IVF_NLIST)]
            self._ivf = IVFBitsIndex.train(
                sample, cfg.IVF_NLIST,
                capacity=max(4 * need, 64 * cfg.IVF_NLIST),
                refine=cfg.IVF_REFINE_K > 0, device=store.device,
            )
            self._ivf_store_ref = weakref.ref(store)
        idx = self._ivf
        chunk = 500_000
        for done in range(idx.total_rows, need, chunk):
            idx.append(store.embeddings[done : min(done + chunk, need)])
        return idx

    def _segmented_index(self):
        """Streaming capacity tier (INDEX_KIND=segmented): only the NEW rows
        are appended on a store mutation, in segments of
        ``max(4096, 4·IVF_NLIST)`` rows; a delete swaps the store object,
        which rebuilds (row ids are append-order store rows)."""
        from .segmented_residual import SegmentedResidualIndex

        cfg = get_config()
        store = self.store
        fresh = (
            not isinstance(self._ivf, SegmentedResidualIndex)
            or self._ivf_store_ref is None
            or self._ivf_store_ref() is not store
            or self._ivf.total_rows > store.valid_n
        )
        if fresh:
            seg_rows = max(4096, cfg.IVF_NLIST * 4)
            sample = store.embeddings[: min(store.valid_n, 8 * seg_rows)]
            self._ivf = SegmentedResidualIndex.train(
                sample, cfg.IVF_NLIST, seg_rows=seg_rows, bits=cfg.IVF_RESIDUAL_BITS,
                refine=cfg.IVF_REFINE_K > 0, device=store.device,
            )
            self._ivf_store_ref = weakref.ref(store)
        idx = self._ivf
        for done in range(idx.total_rows, store.valid_n, idx.seg_rows):
            idx.append(store.embeddings[done : min(done + idx.seg_rows, store.valid_n)])
        return idx

    def _ivf_index(self):
        """The capacity tier of ``INDEX_KIND``. ``ivf`` and ``ivf_residual``
        are built whole from the valid rows, again after every mutation."""
        cfg = get_config()
        if cfg.INDEX_KIND == "bits":
            return self._bits_index()
        if cfg.INDEX_KIND == "segmented":
            return self._segmented_index()
        from .ivf_index import IVFFlatIndex
        from .ivf_residual import IVFResidualIndex

        kind = IVFResidualIndex if cfg.INDEX_KIND == "ivf_residual" else IVFFlatIndex
        if not isinstance(self._ivf, kind) or self._ivf_built_at != self.store.mutation_count:
            rows = self.store.embeddings[: self.store.valid_n]
            if kind is IVFResidualIndex:
                self._ivf = IVFResidualIndex.build(
                    rows, cfg.IVF_NLIST, refine=cfg.IVF_REFINE_K > 0, bits=cfg.IVF_RESIDUAL_BITS,
                    device=self.store.device,
                )
            else:
                self._ivf = IVFFlatIndex.build(rows, cfg.IVF_NLIST, device=self.store.device)
            self._ivf_built_at = self.store.mutation_count
        return self._ivf

    def _routes_ivf(self, cfg, exact: bool | None) -> bool:
        return (
            cfg.INDEX_KIND in ("ivf", "ivf_residual", "segmented", "bits")
            and exact is not True
            and self.store.valid_n >= self._IVF_MIN_ROWS
            and self.metric in ("cosine", "ip")
        )

    def routes_flat(self, cfg=None, *, exact: bool | None = None) -> bool:
        """True when :meth:`search` takes a flat branch, so :meth:`flat_plan`
        describes it; False when it shards or goes through the capacity tier."""
        cfg = cfg or get_config()
        if self._use_sharded(cfg) and exact is not True:
            return False
        return not self._routes_ivf(cfg, exact)

    def search(self, query_embeddings: torch.Tensor, k: int, *, exact: bool | None = None):
        """Top-k over valid rows. Returns (scores [Q,k], rows [Q,k])."""
        store = self.store
        q = query_embeddings.shape[0]
        if store.valid_n == 0:
            return (
                torch.zeros((q, 0), dtype=torch.float32, device=store.device),
                torch.zeros((q, 0), dtype=torch.int32, device=store.device),
            )
        k = min(k, store.valid_n)
        if query_embeddings.shape[1] != store.dim_pad:
            if query_embeddings.shape[1] != store.dim:
                raise ValueError(f"query dim {query_embeddings.shape[1]} != store dim {store.dim}")
            query_embeddings = torch.nn.functional.pad(
                query_embeddings, (0, store.dim_pad - store.dim)
            )
        cfg = get_config()
        if self._use_sharded(cfg) and exact is not True:  # before any capacity tier, as in JAX
            return self._sharded_search(query_embeddings, k, cfg)
        if self._routes_ivf(cfg, exact):
            ivf = self._ivf_index()
            # refine_k only where the tier keeps a host int8 copy (IVFFlatIndex has none)
            kwargs = (
                {"refine_k": cfg.IVF_REFINE_K}
                if cfg.IVF_REFINE_K > 0 and getattr(ivf, "host_int8", None) is not None
                else {}
            )
            vals, rows = ivf.search(query_embeddings, k, nprobe=cfg.IVF_NPROBE, **kwargs)
            if self.metric == "cosine":
                vals = clamp_cosine(vals)
            return vals, rows
        arrays, statics = self.flat_plan(k, exact=exact)
        return dense_dispatch(query_embeddings, arrays, **statics)

    def flat_plan(self, k: int, *, exact: bool | None = None) -> tuple[tuple, dict]:
        """(arrays, statics) for :func:`dense_dispatch`."""
        cfg = get_config()
        store = self.store
        k = min(k, store.valid_n)
        use_kernel = cfg.USE_PALLAS and self.metric in ("cosine", "ip") and exact is not True
        if use_kernel:
            group_l = min(32, choose_group_width(store.valid_n, k))
            while group_l > 8 and store.n_pad % (128 * group_l) != 0:
                group_l //= 2
            if cfg.DENSE_INT8:
                q8, s8, res = self._int8_mirror(residual=cfg.DENSE_INT8_RESIDUAL)
                return (q8, s8, res), dict(
                    kind="fused_int8", k=k, metric=self.metric, valid_n=store.valid_n,
                    group_l=group_l,
                )
            return (store.embeddings,), dict(
                kind="fused", k=k, metric=self.metric, valid_n=store.valid_n, group_l=group_l,
                precise=store.embeddings.dtype == torch.bfloat16,
                # a float16 store has no split-query pass: its candidates are rescored exactly
                rescore=store.embeddings.dtype not in (torch.bfloat16, torch.float32),
            )
        return (store.embeddings,), dict(
            kind="scan", k=k, metric=self.metric, valid_n=store.valid_n,
            block_n=min(cfg.SEARCH_BLOCK_N, store.n_pad),
            rescore=store.embeddings.dtype != torch.float32,
        )
