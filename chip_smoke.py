"""Drives the PyTorch/CUDA port on one NVIDIA GPU and checks it.

Run from the repository root: ``python3 chip_smoke.py`` (all phases).
``--phases 1,2`` runs a subset. Phases:

1. card: ``nvidia-smi`` name and power limit; builds every kernel
   (one nvcc per source) and prints the build time.
2. kernels vs plain: every K1 (``partial_topk``) and K2
   (``partial_topk_int8``) variant against its plain PyTorch version on
   the card, at the shapes of ``CHECK_SHAPES`` (the service store's among
   them). K2 must match bit for bit; K1 values to atol 1e-4 on unit-norm
   data, ids wherever the within-group gap is above 2e-4.
3. service: ``encoder_mid`` embeds ~50k synthetic chunks, the port's
   storage layer writes them, and the port's HTTP service answers 16
   concurrent ``/search`` requests for each store of ``SERVICE_STORES``
   (bf16 and f32 for K1, the int8 and int8r mirrors for K2). Launch
   counts per kernel variant are read around each run (the main path);
   a run that launches any other variant than its store's fails.
4. search at scale: 1M x d1024 corpus, 256 queries embedded by the
   ``bge_m3``-width encoder (random weights from a seed), 100 candidates
   per side, k = 10, through ``_fused_hybrid_search`` with K2 and K1;
   recall@10 against the exact hybrid oracle must be >= 0.99, and each
   path must launch its kernel. The kernel table then checks and times
   every variant against its plain version on the phase-4 inputs.

Prints the kernel table as one ``{"kernels": [...]}`` line, the card's
name and power limit, and as its last line
``{"ok": true, "device": {...}}``. Exits non-zero, with no result line,
when CUDA is unavailable or any phase fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

DEVICE = "cuda"  # every phase runs on the card
H100_HBM_BYTES_S = 3.35e12
H100_PEAK = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}


def log(msg: str) -> None:
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", flush=True)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` in ms over ``iters`` launches."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ phase 1


def phase_build(state: dict) -> None:
    from intool_rag_tpu_torch.kernels import build

    state["card"] = card_line()
    log(f"card: {state['card']}")
    t0 = time.perf_counter()
    for source in build.SOURCES:
        build.load(source)
    state["build_s"] = time.perf_counter() - t0
    for name, text in build.BUILD_LOG.items():
        kept = [ln for ln in text.splitlines() if "registers" in ln or "smem" in ln or "spill" in ln]
        log(f"built {name}: " + " | ".join(kept))
    log(f"kernel build {state['build_s']:.1f} s")


# ------------------------------------------------------------------ phase 2

K2_VARIANTS = {  # name -> (q2, residual)
    "int8": (False, False),
    "int8+q2": (True, False),
    "int8+c2": (False, True),
    "int8r": (True, True),
}
# (n, valid_n, d, query counts, group widths): valid_n inside the last
# block; the last shape is the phase-3 service store (50k rows, d 384)
CHECK_SHAPES = [
    (65_536, 64_536, 384, (3, 64, 256), (8, 32)),
    (65_536, 64_536, 1024, (3, 64, 256), (8, 32)),
    (53_248, 50_000, 384, (1, 16), (32,)),
]


def _unit(gen, shape, dev):
    x = torch.randn(shape, generator=gen, device=dev)
    return x / x.norm(dim=1, keepdim=True)


def _operands(queries, cb, c32, c1, c2, cs) -> dict[str, tuple]:
    """Kernel operands of every K1/K2 variant for these queries: K1 takes
    ``(q_hi, q_lo, corpus)``, K2 ``(q1, q2, c1, c2, cscale)``."""
    from intool_rag_tpu_torch.ops import flat_fused as ff

    q_hi, q_lo = ff.split_query_bf16(queries)
    q1, q2, _ = ff.split_query_int8(queries)
    ops = {
        "K1 bf16 precise": (q_hi, q_lo, cb),
        "K1 bf16": (q_hi, None, cb),
        "K1 f32": (queries.float().contiguous(), None, c32),
    }
    for name, (use_q2, use_c2) in K2_VARIANTS.items():
        ops[f"K2 {name}"] = (q1, q2 if use_q2 else None, c1, c2 if use_c2 else None, cs)
    return ops


def _kernel(name, args, group_l, valid_n):
    from intool_rag_tpu_torch.ops import flat_fused as ff

    fn = ff.partial_topk if name.startswith("K1") else ff.partial_topk_int8
    return fn(*args, group_l, valid_n)


def _plain(name, args, group_l, valid_n):
    from intool_rag_tpu_torch.ops import flat_fused as ff

    fn = ff.partial_topk_reference if name.startswith("K1") else ff.partial_topk_int8_reference
    return fn(*args, group_l, valid_n)


def _compare(name, args, kout, pout) -> float:
    """Max |value diff| of a kernel's candidates against its plain version's.
    Raises unless K2 matches bit for bit, or K1 values agree to 1e-4 and
    every id that differs is the kernel's pick within 2e-4 of the group max."""
    (kv, ki), (pv, pi) = kout, pout
    if name.startswith("K2"):
        if not (torch.equal(kv, pv) and torch.equal(ki, pi)):
            finite = torch.isfinite(pv)
            err = (kv[finite] - pv[finite]).abs().max().item()
            raise AssertionError(f"{name} not bit-exact: max |diff| {err}, ids differ {int((ki != pi).sum())}")
        return 0.0
    finite = torch.isfinite(pv)
    if not torch.equal(finite, torch.isfinite(kv)):
        raise AssertionError(f"{name}: -inf pattern differs from the plain version")
    err = (kv[finite] - pv[finite]).abs().max().item() if finite.any() else 0.0
    if err > 1e-4:
        raise AssertionError(f"{name} value error {err} > 1e-4")
    diff = ki != pi
    if diff.any():
        q_hi, q_lo, corpus = args
        c = corpus.float()
        s = q_hi.float() @ c.T
        if q_lo is not None:
            s = s + q_lo.float() @ c.T
        gap = (pv - torch.gather(s, 1, ki.long()))[diff].abs().max().item()
        if gap > 2e-4:
            raise AssertionError(f"{name}: id differs at within-group gap {gap}")
    return err


def phase_kernels(state: dict) -> None:
    from intool_rag_tpu_torch.ops.quant import quantize_int8_residual

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(0)
    errs: dict[str, float] = {}
    checks = 0
    for n, valid_n, d, query_counts, widths in CHECK_SHAPES:
        corpus = _unit(gen, (n, d), dev)
        cb = corpus.bfloat16().contiguous()
        c1, c2, cs = quantize_int8_residual(corpus)
        for q in query_counts:
            ops = _operands(_unit(gen, (q, d), dev), cb, corpus, c1, c2, cs)
            for g in widths:
                for name, args in ops.items():
                    kout = _kernel(name, args, g, valid_n)
                    torch.cuda.synchronize()
                    err = _compare(name, args, kout, _plain(name, args, g, valid_n))
                    errs[name] = max(errs.get(name, 0.0), err)
                    checks += 1
        del corpus, cb, c1, c2, cs
    torch.cuda.empty_cache()
    state["max_abs_err"] = errs
    log(f"phase 2: {checks} kernel-vs-plain checks passed; max |err| {json.dumps(errs)}")


# ------------------------------------------------------------------ phase 3

ROOT = Path(__file__).resolve().parent
ENCODER_MID = ROOT / "intool_rag_tpu" / "models" / "weights" / "encoder_mid.npz"
N_SERVICE_DOCS, CHUNKS_PER_DOC, N_REQUESTS = 200, 250, 16
SERVICE_STORES = [  # (label, env, the only kernel variant that store may launch)
    ("K1 bf16 store", {"DENSE_INT8": "0", "DENSE_INT8_RESIDUAL": "0"}, "K1 bf16 precise"),
    ("K1 f32 store", {"INDEX_DTYPE": "float32", "DENSE_INT8": "0", "DENSE_INT8_RESIDUAL": "0"}, "K1 f32"),
    ("K2 int8 mirror", {"DENSE_INT8": "1", "DENSE_INT8_RESIDUAL": "0"}, "K2 int8+q2"),
    ("K2 int8r mirror", {"DENSE_INT8": "1", "DENSE_INT8_RESIDUAL": "1"}, "K2 int8r"),
]


def _word_corpus(rng: np.random.Generator):
    """Seeded synthetic chunk texts: Zipf-distributed pseudo-words."""
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    vocab = ["".join(rng.choice(letters, size=rng.integers(3, 10))) for _ in range(20_000)]
    n = N_SERVICE_DOCS * CHUNKS_PER_DOC
    lengths = rng.integers(30, 60, size=n)
    picks = (rng.zipf(1.3, size=int(lengths.sum())) - 1) % len(vocab)
    texts, pos = [], 0
    for length in lengths:
        texts.append(" ".join(vocab[w] for w in picks[pos : pos + length]))
        pos += length
    return vocab, texts


def _write_storage(storage_dir: Path, texts: list[str], provider) -> None:
    from intool_rag_tpu_torch.ingest.schemas import (
        Chunk, ChunksIndex, NodeLevel, PageIndex, SemanticNode, VectorMeta, make_chunk_id,
    )
    from intool_rag_tpu_torch.storage.artifacts import FileStorageManager

    fsm = FileStorageManager(storage_dir)
    t0 = time.perf_counter()
    emb = provider.embed_batch(texts, is_query=False)
    log(f"embedded {len(texts)} chunks with encoder_mid in {time.perf_counter() - t0:.1f} s")
    for d in range(N_SERVICE_DOCS):
        doc_id = f"doc{d:03d}"
        rows = range(d * CHUNKS_PER_DOC, (d + 1) * CHUNKS_PER_DOC)
        pages = [i * 25 // CHUNKS_PER_DOC for i in range(CHUNKS_PER_DOC)]
        chunk_ids = [make_chunk_id(p, i) for i, p in enumerate(pages)]
        nodes = [
            SemanticNode("n_000", f"Chapter {d}", NodeLevel.CHAPTER, 0, children=["n_001"]),
            SemanticNode("n_001", f"Section {d}.1", NodeLevel.SECTION, 0, parent_id="n_000"),
        ]
        fsm.save_page_index(PageIndex(doc_id, f"{doc_id}.pdf", f"project{d % 4}", "en", 25, nodes))
        fsm.save_chunks(ChunksIndex(doc_id, [
            Chunk(cid, "n_001", p, texts[r]) for cid, p, r in zip(chunk_ids, pages, rows)
        ]))
        fsm.save_vectors(doc_id, emb[rows.start : rows.stop], VectorMeta(
            doc_id, "encoder_mid", emb.shape[1], CHUNKS_PER_DOC, chunk_ids, pages))


def _post(port: int, question: str) -> tuple[float, dict]:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/search", data=json.dumps({"question": question}).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as resp:
        body = json.loads(resp.read())
        if resp.status != 200:
            raise AssertionError(f"/search returned {resp.status}: {body}")
    return time.perf_counter() - t0, body


def _launches() -> dict[str, int]:
    from intool_rag_tpu_torch.ops.flat_fused import partial_topk, partial_topk_int8

    return {**partial_topk.launches.by_variant, **partial_topk_int8.launches.by_variant}


def _reset_launches() -> None:
    from intool_rag_tpu_torch.ops.flat_fused import partial_topk, partial_topk_int8

    partial_topk.launches.reset()
    partial_topk_int8.launches.reset()


def _serve_and_query(label: str, env: dict, variant: str, provider, questions, expected) -> dict:
    from intool_rag_tpu_torch import config
    from intool_rag_tpu_torch.service.app import RAGService
    from intool_rag_tpu_torch.service.http import ServiceServer

    os.environ.update(env)
    config.reset_config()
    t0 = time.perf_counter()
    service = RAGService(provider, device=DEVICE)
    load_s = time.perf_counter() - t0
    server = ServiceServer(service, host="127.0.0.1", port=0)
    server.start_background()
    try:
        _post(server.port, "warm up the search path")  # first-call allocations, mirror build
        _reset_launches()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=N_REQUESTS) as pool:
            results = list(pool.map(lambda q: _post(server.port, q), questions))
        wall = time.perf_counter() - t0
        launches = _launches()
        batches = service.batcher.batches_run
    finally:
        server.shutdown()
    if set(launches) != {variant}:
        raise AssertionError(f"{label}: main path launched {launches}, expected only {variant}")
    lat = sorted(r[0] for r in results)
    for (_, body), want in zip(results, expected):
        if want is None:
            if not body["hits"]:
                raise AssertionError(f"{label}: empty /search result")
            continue
        top = [(h["doc_id"], h["chunk_id"]) for h in body["hits"][:5]]
        if want not in top:
            raise AssertionError(f"{label}: quoted chunk {want} not in top 5 {top}")
    out = {
        "run": label, "requests": len(questions), "p50_ms": 1000 * float(np.median(lat)),
        "max_ms": 1000 * lat[-1], "qps": len(questions) / wall, "launches": launches,
        "batches_incl_warmup": batches, "service_load_s": load_s,
    }
    log(f"phase 3 {label}: {json.dumps(out)}")
    return out


def phase_service(state: dict) -> None:
    from intool_rag_tpu_torch.providers.cuda_embed import CudaEmbeddingProvider

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(1)
    vocab, texts = _word_corpus(rng)
    provider = CudaEmbeddingProvider(checkpoint=str(ENCODER_MID), device=DEVICE)
    quoted = rng.choice(len(texts), size=N_REQUESTS // 2, replace=False)
    questions, expected = [], []
    for r in quoted:
        questions.append(texts[r])
        d, i = divmod(int(r), CHUNKS_PER_DOC)
        expected.append((f"doc{d:03d}", f"c_{i * 25 // CHUNKS_PER_DOC:03d}_{i:03d}"))
    for _ in range(N_REQUESTS - len(quoted)):
        questions.append(" ".join(rng.choice(vocab[:2000], size=4)))
        expected.append(None)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_storage_") as tmp:
        _write_storage(Path(tmp), texts, provider)
        # encoder_mid was trained without a query instruction; the JAX
        # package's own quality tests for it also set it empty
        base = {"STORAGE_DIR": tmp, "INDEX_DTYPE": "bfloat16", "USE_PALLAS": "1",
                "EMBEDDING_QUERY_INSTRUCTION": ""}
        runs = [
            _serve_and_query(label, {**base, **env}, variant, provider, questions, expected)
            for label, env, variant in SERVICE_STORES
        ]
    state["service"] = runs
    launches: dict[str, int] = {}
    for run in runs:
        for name, count in run["launches"].items():
            launches[name] = launches.get(name, 0) + count
    state["launches"] = launches


# ------------------------------------------------------------------ phase 4

N_SCALE, DIM, Q_SCALE, TOP_K, CANDIDATES = 1_000_000, 1024, 256, 10, 100
VOCAB, TERMS_PER_CHUNK, QUERY_TERMS, P_MAX, ORACLE_Q = 100_000, 64, 8, 512, 64


def make_sparse(rng, n, vocab, p_max):
    """Synthetic Zipf postings in the BM25Index layout (terms deduplicated
    per chunk, impact-ordered within a term, capped at p_max), plus
    [Q_SCALE, QUERY_TERMS] query terms."""
    chunk_terms = (rng.zipf(1.2, size=(n, TERMS_PER_CHUNK)) - 1) % vocab
    weights = rng.random((n, TERMS_PER_CHUNK)).astype(np.float32) + 0.5
    sort_idx = np.argsort(chunk_terms, axis=1, kind="stable")
    st = np.take_along_axis(chunk_terms, sort_idx, axis=1)
    dup = np.concatenate([np.zeros((n, 1), bool), st[:, 1:] == st[:, :-1]], axis=1)
    keep = ~dup.ravel()
    flat_terms = st.ravel()[keep]
    flat_docs = np.repeat(np.arange(n, dtype=np.int32), TERMS_PER_CHUNK)[keep]
    flat_w = np.take_along_axis(weights, sort_idx, axis=1).ravel()[keep]
    order = np.lexsort((-flat_w, flat_terms))
    flat_terms, flat_docs, flat_w = flat_terms[order], flat_docs[order], flat_w[order]
    df = np.bincount(flat_terms, minlength=vocab)
    counts = np.minimum(df, p_max)
    starts64 = np.zeros(vocab, np.int64)
    starts64[1:] = np.cumsum(df)[:-1]
    rank = np.arange(len(flat_terms), dtype=np.int64) - starts64[flat_terms]
    keep2 = rank < p_max
    term_start = np.zeros(vocab, np.int32)
    term_start[1:] = np.cumsum(counts[:-1]).astype(np.int32)
    post_docs = np.concatenate([flat_docs[keep2], np.full(p_max, n, np.int32)])
    post_w = np.concatenate([flat_w[keep2], np.zeros(p_max, np.float32)]).astype(np.float32)
    idf = np.log(1.0 + (n - df + 0.5) / (df + 0.5)).astype(np.float32)
    qterms = ((rng.zipf(1.2, size=(Q_SCALE, QUERY_TERMS)) - 1) % vocab).astype(np.int32)
    qtf = np.ones((Q_SCALE, QUERY_TERMS), np.float32)
    return term_start, counts.astype(np.int32), post_docs, post_w, idf, qterms, qtf


def _bound(q, n, d, passes, elem, n_q_ops, n_c_ops, peak, cand_cols, scales=False):
    """Least time (ms) for one kernel call: max(bytes / HBM rate,
    operations / peak), inputs read once, outputs written once."""
    nbytes = n_q_ops * q * d * elem + n_c_ops * n * d * elem + (4 * n if scales else 0) + q * cand_cols * 8
    ops = passes * 2.0 * q * n * d
    t_bytes, t_ops = nbytes / H100_HBM_BYTES_S, ops / peak
    return 1000 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_scale(state: dict) -> None:
    from intool_rag_tpu_torch.index.bm25_index import bm25_dispatch
    from intool_rag_tpu_torch.index.hybrid import _fuse, _fused_hybrid_search
    from intool_rag_tpu_torch.models.encoder import EncoderConfig, TextEncoder
    from intool_rag_tpu_torch.ops import flat_fused as ff
    from intool_rag_tpu_torch.ops.bm25 import bm25_topk_sorted, build_row_layout
    from intool_rag_tpu_torch.ops.quant import quantize_int8_residual
    from intool_rag_tpu_torch.ops.topk import flat_topk, rescore_candidates
    from intool_rag_tpu_torch.providers.cuda_embed import CudaEmbeddingProvider

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(7)
    n, n_pad = N_SCALE, -(-N_SCALE // 4096) * 4096
    t0 = time.perf_counter()
    sparse = make_sparse(np.random.default_rng(0), n, VOCAB, P_MAX)
    log(f"phase 4: postings built on host in {time.perf_counter() - t0:.1f} s")
    ts, tl, pd, pw, idf, qterms, qtf = (torch.as_tensor(x, device=dev) for x in sparse)
    rows = build_row_layout(ts, tl, pd, pw, n_docs=n, p_max=P_MAX)
    bm25_arrays = (rows["term_row"], rows["term_hot"], rows["hot_docs"], rows["hot_w"],
                   rows["cold_docs"], rows["cold_w"], idf, rows["term_wmax"])

    corpus = torch.randn((n_pad, DIM), generator=gen, device=dev)
    corpus = (corpus / corpus.norm(dim=1, keepdim=True)).bfloat16()
    c1, c2, cs = quantize_int8_residual(corpus)

    encoder = TextEncoder(EncoderConfig.bge_m3(), device=dev).init_random(gen)
    provider = CudaEmbeddingProvider(encoder)
    texts = [" ".join(f"term{t}" for t in row) for row in sparse[5]]
    t0 = time.perf_counter()
    q_emb = torch.as_tensor(provider.embed_batch(texts, is_query=True), device=dev)
    torch.cuda.synchronize()
    log(f"phase 4: embedded {len(texts)} queries with the bge_m3-width encoder "
        f"(random weights) in {time.perf_counter() - t0:.2f} s")
    del encoder, provider
    torch.cuda.empty_cache()

    statics = dict(k=TOP_K, kc=CANDIDATES, fusion_mode="weighted", rrf_k=60, metric="cosine",
                   valid_n=n, group_l=32, packed=True, hot_cap=None, n_docs=n)
    paths = {
        "K2 int8r": ((c1, cs, c2), dict(kind="fused_int8")),
        "K1 bf16 precise": ((corpus,), dict(kind="fused", precise=True)),
    }

    def hybrid(name, qt, q=q_emb):
        arrays, kind = paths[name]
        return _fused_hybrid_search(q, arrays, qt, qtf, bm25_arrays, 0.7, 0.3, **statics, **kind)

    # exact hybrid oracle on ORACLE_Q queries: exact f32-accumulated dense
    # top-k + exact f32 rescore, exact BM25, the same fusion
    qo, qto = q_emb[:ORACLE_Q], qterms[:ORACLE_Q]
    d_vals, d_rows = flat_topk(qo, corpus, CANDIDATES, metric="cosine", block_n=100_000, valid_n=n)
    d_vals = rescore_candidates(qo, corpus, d_rows, metric="cosine")
    s_vals, s_rows = bm25_topk_sorted(qto, qtf[:ORACLE_Q], ts, tl, pd, pw, idf, CANDIDATES,
                                      n_docs=n, p_max=P_MAX)
    _, oracle = _fuse(d_vals, d_rows, s_vals, s_rows, TOP_K, fusion_mode="weighted", rrf_k=60,
                      w_dense=0.7, w_sparse=0.3)
    oracle = oracle.cpu().numpy()

    rotations = [(qterms + 31 * i) % VOCAB for i in range(4)]
    results = {}
    state["launches_scale"] = {}
    for name in paths:
        _reset_launches()
        _, fast = hybrid(name, qterms)
        fast = fast[:ORACLE_Q].cpu().numpy()
        recall = sum(len(set(a) & set(b)) for a, b in zip(fast, oracle)) / oracle.size
        if recall < 0.99:
            raise AssertionError(f"{name}: recall@10 {recall} < 0.99 vs the exact hybrid oracle")
        qps = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for qt in rotations:
                hybrid(name, qt)
            torch.cuda.synchronize()
            qps.append(Q_SCALE * len(rotations) / (time.perf_counter() - t0))
        launches = _launches()
        if set(launches) != {name}:
            raise AssertionError(f"phase 4 {name}: launched {launches}, expected only {name}")
        state["launches_scale"][name] = launches[name]
        results[name] = {"recall@10": recall, "qps_mean": float(np.mean(qps)),
                         "qps_sd": float(np.std(qps)), "qps_runs": qps}

    # per-stage device times: each dense kernel, then the tail, BM25 and
    # fusion (shared by both paths) on the int8r candidates
    q1, q2, _ = ff.split_query_int8(q_emb)
    q_hi, q_lo = ff.split_query_bf16(q_emb)
    stage = {
        "K2 int8r": lambda: ff.partial_topk_int8(q1, q2, c1, c2, cs, 32, n),
        "K1 bf16 precise": lambda: ff.partial_topk(q_hi, q_lo, corpus, 32, n),
    }
    cand = stage["K2 int8r"]()

    def bm25():
        return bm25_dispatch(qterms, qtf, bm25_arrays, k=CANDIDATES, packed=True, n_docs=n, hot_cap=None)

    s_vals, s_rows = bm25()
    d_vals, d_rows = ff._candidates_topk(*cand, CANDIDATES, tail="fold")
    common = {
        "tail_ms": cuda_ms(lambda: ff._candidates_topk(*cand, CANDIDATES, tail="fold")),
        "bm25_ms": cuda_ms(bm25),
        "fusion_ms": cuda_ms(lambda: _fuse(d_vals.clamp(0, 1), d_rows, s_vals, s_rows, TOP_K,
                                           fusion_mode="weighted", rrf_k=60, w_dense=0.7, w_sparse=0.3)),
    }
    for name in paths:
        results[name]["dense_kernel_ms"] = cuda_ms(stage[name])
        results[name].update(common)
    del cand
    state["scale"] = results
    log(f"phase 4 (1M x d1024, Q 256, k 10 of 100 per side): {json.dumps(results)}")
    state["kernels"] = _kernel_table(state, q_emb, corpus, c1, c2, cs, n)


def _kernel_table(state, q_emb, corpus, c1, c2, cs, n) -> list[dict]:
    """Every kernel variant at the phase-4 shape: the kernel checked against
    its plain version on the same inputs, both timed, the product-only
    library time, the bound, and the launches of the main-path runs."""
    n_pad, d = corpus.shape
    q = q_emb.shape[0]
    g = 32
    cols = n_pad // g
    c32 = corpus.float()
    errs = state.get("max_abs_err", {})
    src = "intool_rag_tpu_torch/kernels/flat_partial_topk.cu"
    replaces = {"K1": "intool_rag_tpu/ops/flat_pallas.py:96", "K2": "intool_rag_tpu/ops/flat_pallas.py:136"}
    rows = []
    for name, args in _operands(q_emb, corpus, c32, c1, c2, cs).items():
        family = name[:2]
        if family == "K1":
            a_hi, a_lo, c = args
            products = [(a, c.T) for a in (a_hi, a_lo) if a is not None]
            dtype = "f32" if c.dtype == torch.float32 else "bf16"
            bound = _bound(q, n_pad, d, len(products), c.element_size(), len(products), 1,
                           H100_PEAK[dtype], cols)
            library = lambda products=products: [torch.mm(a, b) for a, b in products]
        else:
            a1, a2, b1, b2, _ = args
            products = [(a1, b1.T)] + ([(a2, b1.T)] if a2 is not None else []) + (
                [(a1, b2.T)] if b2 is not None else [])
            bound = _bound(q, n_pad, d, len(products), 1, 1 + (a2 is not None), 1 + (b2 is not None),
                           H100_PEAK["int8"], cols, scales=True)
            library = lambda products=products: [torch._int_mm(a, b) for a, b in products]
        kernel = lambda name=name, args=args: _kernel(name, args, g, n)
        plain = lambda name=name, args=args: _plain(name, args, g, n)
        err = _compare(name, args, kernel(), plain())
        torch.cuda.empty_cache()
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces[family],
            # main path: the phase-3 service runs; null for a variant no store runs
            "launches": state.get("launches", {}).get(name),
            "launches_scale": state.get("launches_scale", {}).get(name),
            "max_abs_err": max(err, errs.get(name, 0.0)),
            "ms": cuda_ms(kernel), "plain_ms": cuda_ms(plain, iters=2, warmup=1),
            "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": cuda_ms(library, iters=5, warmup=1),
        }
        torch.cuda.empty_cache()
        rows.append(entry)
        log(f"kernel {json.dumps(entry)}")
    return rows


PHASES = {1: phase_build, 2: phase_kernels, 3: phase_service, 4: phase_scale}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default="1,2,3,4")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    phases = [int(p) for p in args.phases.split(",")]
    state: dict = {}
    for p in phases:
        t0 = time.perf_counter()
        PHASES[p](state)
        log(f"phase {p} done in {time.perf_counter() - t0:.1f} s")
    if "kernels" in state:
        print(json.dumps({"kernels": state["kernels"]}))
    print(state.get("card") or card_line())
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
