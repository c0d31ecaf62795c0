"""Drives the PyTorch/CUDA port on one NVIDIA GPU and checks it.

Run from the repository root: ``python3 chip_smoke.py`` (all phases).
``--phases 1,2`` runs a subset (``1,2,5`` for the capacity tier alone,
``1,2,6`` for ingest alone, ``1,2,7`` for training alone, ``1,8`` for
``/query`` alone, ``1,9`` for the rest of the served surface alone,
``1,10`` for the OCR fallback alone, ``1,11`` for the capacity tiers
alone, ``1,12`` for the trainers alone, ``1,13`` for corpus sharding
alone, ``1,14`` for model parallelism alone, ``1,15`` for the DeepSeek
one-token step's kernels alone). Phases:

1. card: ``nvidia-smi`` name and power limit; builds every kernel
   (one nvcc per source, all started together) and prints the build time
   and each kernel's registers and shared memory: for K1/K2's tensor-core
   kernels per variant and query-tile width, for K3's scan (per plane width)
   and plan, for K5's four forward entries (bf16, f32; with and without the
   saved residuals) and its four backward entries (dkv, dq; bf16, f32), with
   their spill bytes, and fails if any of them spills or the compiler warns
   on any of those four sources, or if ptxas serializes the wgmma pipeline
   of a K5 forward (bf16, f32) or of the f32 backward kernels (dkv, dq).
2. kernels vs plain: every K1 (``partial_topk``: bf16, bf16 precise, f16,
   f32) and K2 (``partial_topk_int8``: int8, +q2, +c2, int8r) variant
   against its plain PyTorch version on the card, at the shapes of
   ``CHECK_SHAPES`` (Q 300 over several query tiles, the service store at
   batch 1-16 with split blocks, valid_n inside a 128-row tile, D 384 and
   1024) and on near-duplicate queries (``NEAR_QUERIES``: corpus rows plus
   noise of 1e-3, scores about 1) at D 384 and 1024. K2 must match bit for
   bit, K2 and K1 f32 (3xTF32) a repeated run bit for bit; K1 values to
   atol 1e-4 on unit-norm data, ids wherever the within-group gap is
   above 2e-4. K3
   (``bits_scan``) at the shapes of ``K3_CHECKS`` (the service store's and
   the capacity run's among them, with empty slots and an all-empty
   list) and ``K3_PLAN_CHECKS`` (one list probed by every tile, more than
   the plan's group cap; every tile probing the all-empty list): values to
   rtol 2e-5 / atol 1e-5, ids wherever the within-group gap is above 1e-5,
   each call repeated bit for bit, and the kernel's scan plan equal to
   ``scan_plan_reference``. K4 (``quantize_int8_stochastic``): scales bit-equal,
   every code at floor or floor+1, seeds repeatable and distinct, the
   64-seed mean unbiased, and the rounding-up rate within 3 sigma of the
   plain version's. K5 (``flash_attention_segments``) at the shapes of
   ``K5_CHECKS`` (f32 and bf16; S 128, 1024, 2048; B 1 and 3; H 16 and 6)
   on every layout of ``_segment_layouts``, on rows no key matches and on
   ``_skip_layouts``, and at S 8192 one head at a time: atol 2e-5 (f32) and
   2e-2 (bf16) on unit-variance inputs, and bf16 also per query row within
   2^-6 of the row's largest |value| (``K5_FWD_REL_BF16``, which holds the
   long rows, where |o| is about 0.02); bf16 and f32 (3xTF32) with and
   without the saved residuals, each run twice, bit-equal, with every CTA's
   own count of the tiles it loaded and computed equal to the skip rule's
   plain model (``computed_tiles`` at that dtype's tiles, with ``m`` from
   that launch); k and v expanded over the heads give the bits of their
   copies; unsupported shapes must raise. K5's backward
   kernels (dkv and dq) at the same shapes and layouts, and at the edges of
   the kernels' tile skip (``_skip_layouts``: a row no key matches in a
   tile that would otherwise be skipped, interleaved ids that differ between
   queries and keys), on the encoder's
   strided views, against the plain backward given the kernel forward's own
   ``o, l, m``: atol 5e-5 (f32) and two bf16 steps of the largest gradient
   (bf16); the forward's saved ``l, m`` against the plain version's; every
   backward run twice, bit-equal; once through ``torch.autograd``; each
   CTA's own count of the tiles it loaded and computed equal to the skip
   rule's plain model (``computed_tiles`` at the kernel's tiles: bf16 and
   f32, 3xTF32 on the tensor cores, have their own).
3. service: ``encoder_mid`` embeds ~50k synthetic chunks, the port's
   storage layer writes them, and the port's HTTP service answers 16
   concurrent ``/search`` requests for each store of ``SERVICE_STORES``
   (bf16, f32 and f16 for K1, the int8 and int8r mirrors for K2, and the
   ``INDEX_KIND=bits`` capacity tier for K3). Launch counts per kernel
   variant are set to 0 before each run and read after it (the main
   path); a run that launches any other variant than its store's fails.
   Then the port's native analyzer must have built and serve ``tokenize``
   (``€uro`` keeps its symbol), and a service on a fresh store with
   ``LLM_PROVIDER`` unset, no Gemini key and no Ollama must answer
   ``POST /ingest`` through the heuristic analyzer.
4. search at scale: 1M x d1024 corpus, 256 queries embedded by the
   ``bge_m3``-width encoder (random weights from a seed), 100 candidates
   per side, k = 10, through ``_fused_hybrid_search`` with K2 int8r, K1
   bf16 precise and K1 f32 (a true f32 corpus drawn in f32, 4.1 GB);
   recall@10 against the exact hybrid oracle of its corpus must be >= 0.99, and each
   path must launch its kernel and no other; ``torch.profiler`` over the
   same rotations gives the device's busy share of a batch, against an
   unprofiled pass just before it (measured after the last phase, since a
   traced process runs its host side slower and phases 5-7 time host
   work). The kernel table
   then checks and times every variant against its plain version on the
   phase-4 inputs (K1 f32 on the f32 corpus), and every variant at the
   phase-3 service shape (``SERVICE_SHAPE``), each with its bound, share
   of the bound and library time (K1 f32: the 3xTF32 bound, and the
   f32-FMA bound beside it).
5. capacity run: the 1-bit tier at full width. 3,000,000 x d1024 rows
   with micro-cluster structure stream into an ``IVFBitsIndex`` (nlist
   256, 13 blocks of 1,024 slots per list, host int8 refine tier) in
   twelve appends; 256 queries, k 10 of a refined pool of 100, nprobe
   8/16/32. Recall@10 and pool@100 against a streamed exact-f32 oracle
   must be >= 0.95 at nprobe 16, and the dense side may launch K3 only.
   K3 (with the bytes of the distinct, scanned and planned blocks, and its
   time at the service shape) and K4 then join the kernel table.
6. ingest at full width: the ``bge_m3``-width encoder (24 x 1024, 16 heads,
   bf16, ``flash_min_len`` 1024, random weights from a seed) behind the
   port's HTTP service on a fresh ``STORAGE_DIR``, twice. Packed:
   ``EMBED_PACKED=1 EMBED_PACK_WIDTH=2048``, eight form-feed-paginated
   text files and one text PDF the script writes itself (Flate content
   streams, a font readable only through its ToUnicode CMap) go through
   ``POST /ingest``, one of them with ``mode=async`` and
   ``GET /jobs/{id}``; a few hundred chunks at the default ``CHUNK_*``.
   Long context: packing off and ``CHUNK_*_CHARS`` raised, so that pages
   of 600-7,000 tokens stay whole and land in the 1024, 2048, 4096 and
   8192 buckets. After each run K5 must have launched 24 times per
   encoder forward at S >= 1024 and nothing else, its plain version not
   at all, and peak device memory must lie far below one row's f32
   logits at S 8192. Then ``/search`` must return the quoted chunk of
   every document in the top 5 (the encoder's weights are random, so BM25
   carries this: it gets weight 0.7), ``GET /documents/{id}`` must show
   the tree, ``DELETE /documents/{id}`` must remove that document's
   chunks from ``/search`` and leave the others, and the appended BM25
   vocabulary must equal a fresh build's. The same batches embedded on
   the K5 route and with ``flash_min_len=0``, and packed against padded,
   must agree to cosine 0.999 row by row. K5's time per launch at each
   shape, the encoder forward and K5's kernel-table rows (S 8192, with
   the library's attention beside it; f32 with its 3xTF32 bound and the
   f32-FMA bound beside; each with the share of tiles it computed) follow.
7. training at full width: ``make_train_step`` on the ``bge_m3``
   configuration (24 x 1024, f32 master weights, bf16 compute, seeded
   random init, AdamW), six steps on a fixed batch of 4 queries x S 128
   (key-mask route) and 4 passages x S 2048 (K5 route), then two steps
   with 2 pairs whose passages have S 8192. Per step K5 forward, dkv and dq
   must each launch 24 times and their plain versions not at all, every
   loss must be finite, the repeated batch's loss must fall, and the peak
   device memory must lie far below 24 layers of f32 S x S logits. Then
   gradients on a 2-layer copy, K5 route against ``flash_min_len=0``
   (cosine >= 0.999 per parameter tensor); ``train_encoder_cached`` and
   ``train_reranker`` on short rows at ``encoder_mid`` width on the synthetic
   relevance task (trained encoder beats untrained on dense NDCG@10,
   trained reranker beats hybrid retrieval); ``Reranker.score_pairs`` of
   100 pairs at ``bge_m3`` width, packed rows through K5 against the
   bucketed scores. K5 forward / dkv / dq per launch at the two training
   shapes and the backward kernels' kernel-table rows (S 8192, beside the
   plain backward and ``torch.autograd`` through the library's attention,
   with the share of tiles each kernel computes; f32 with its 3xTF32 bound
   and its f32-FMA bound beside) follow.

8. ``/query`` at full width: the port's HTTP service on a fresh
   ``STORAGE_DIR`` and ``CACHE_DIR`` with ``encoder_mid`` ingests phase 6's
   packed documents through ``POST /ingest`` (BM25 weight 0.7, as in phase
   6: the pseudo-words lie outside the encoder's training text). With
   ``LLM_PROVIDER=fake``: 16 concurrent ``/query`` requests, each quoting a
   sentence that names its chunk, must answer with that sentence and cite
   its document and page first; K1 bf16 precise (the store's kernel) must
   launch and no plain version run; the same request again is a cache hit
   with an equal body; ``stream: true`` over HTTP gives ``sources``, then
   ``token`` events, then ``done``. With ``LLM_PROVIDER=cuda`` (the
   factory's choice is checked) the service answers 8 concurrent requests
   with ``CudaLLM(DecoderConfig.tinyllama())`` (22 x 2048, 32 heads over 4
   KV heads, 5,632, vocabulary 32,000, 2,048 positions, bf16, seeded random
   weights, byte tokenizer, temperature 0, 64 new tokens; the context cut
   to 600 characters so that the prompt fits the 1,024 bucket), its
   parameters and every cache on the card; one question twice gives one
   answer. Off the main path: cached decode against a full forward on a
   2-layer f32 copy (1e-4) and on the bf16 model (``BF16_CACHE_*``), both
   on random ids and on one served request's own inputs (its left-padded
   1,024-token prompt, then the tokens it decoded), and the tiny f32
   config's greedy tokens on the card against the CPU's. It
   prints prefill ms at 512, 1,024 and 2,048 tokens, decode ms per token at
   batch 1 after a 1,024-token prompt and tokens/s, the weight-read bound
   (bf16 weight bytes over 3.35 TB/s) and the share of it reached,
   ``/query`` p50 split into retrieve and generate, peak device memory,
   and, after the last phase, the device's busy share of a decode step and
   its launches per token from ``torch.profiler``; each beside the card's
   name and power limit. The kernel table's rows gain ``launches_query``.
9. the rest of the served surface, over a store like phase 8's (its
   uploads, ``encoder_mid``, bf16, BM25 weight 0.7) behind the port's HTTP
   service. The agent: 16 concurrent ``POST /agent/query`` with the fake
   LLM (the main path); every quote that ``/query`` answers with its page
   first must come back with that page among the agent's sources and the
   quote in its answer; K1 bf16 precise must launch and no plain version
   run; the gate's refusals are printed; ``GET /agent/health`` answers and
   ``GET /metrics`` counts every request the phase sent and holds
   ``agent.query``. Then ``CudaLLM(DecoderConfig.tinyllama())`` (phase 8's
   seeded weights, temperature 0, 64 new tokens, phase 8's 8 prompts, the
   query cache off) behind ``/query``, 8 requests at once, three ways:
   ``LLM_CONTINUOUS_SLOTS=8`` (wall, generate p50, waves and compactions
   beside phase 8's queued numbers), ``LLM_SPECULATIVE_GAMMA=4`` one stream,
   and both (speculative waves over 8 slots). Each request's tokens are
   held to the static ``generate`` of its prompt up to the static path's
   first top-2 margin below ``BF16_CACHE_REL`` of its largest logit (bf16
   sums differ with batch width), with the share of tokens equal printed.
   The 2-layer f32 copy through the scheduler (4 slots, 192 positions, at
   least one compaction) must give the static tokens outright. On a prompt
   that repeats its context: ms a token plain, speculative and in waves,
   and ``llm.accepted_per_wave``. Last of the whole run, after every
   timing: ``POST /debug/trace`` (0.5 s) while ``/agent/query`` requests
   run must write one Chrome trace holding CUDA kernel events
   (``--trace-windows N`` repeats the window N times, with 1 and 4 request
   threads in turn). The kernel table's rows gain ``launches_served``.
10. scanned ingest: the committed scanned fixture
   (``intool_rag_tpu_torch/ocr/fixtures/scanned_invoices.pdf``: 8 US Letter
   pages at 144 DPI, 1,224 x 1,584 px, 20-27 ground-truth lines each, one
   FlateDecode grayscale image a page). ``OCREngine`` on the shipped
   det / cls / rec weights on the card, at ``det_limit`` 1280 (the JAX
   invoice eval's engine) and 640 (the one the service builds), float32
   with cuDNN's TF32 off: per page the wall s, ``elapse``, the CUDA-event
   span of the model forwards, the host time besides and the forwards;
   exact and fuzzy rates as ``evaluate_on_invoices`` scores them. The same
   pages through the port on the CPU must give the same texts, page by
   page. One page's forwards timed with TF32 on as well (a reading, not
   used). Then ``POST /ingest`` of the PDF through the port's HTTP service
   on the default configuration (``OCR_ENABLED`` unset, every setting of an
   earlier phase removed) over an ``encoder_mid`` store: every page must
   come back with ``has_ocr`` and non-empty text, and ``/search`` for one
   recognised line of each page (its longest line no other page holds)
   must find that page in the top 5, with K1 launched and no plain version
   called; the ingest wall s and s per page. After the last phase, one
   page under ``torch.profiler`` gives the device's busy share. The kernel
   table's rows gain ``launches_scanned``.
11. capacity tiers: phase 5's 3,000,000 x d1024 micro-cluster corpus
   (whole on the card in f32), its queries and its streamed exact-f32
   oracle. Built in turn and freed before the next: ``IVFFlatIndex`` in
   bf16, ``IVFResidualIndex`` with int4 and with sign codes (each with the
   host int8 refine tier), nlist 4,096, and ``SegmentedResidualIndex``
   (sign codes, refine tier, k-means on the first 500,000 rows, six
   appends of 500,000, as ``benchmarks/bench_segmented.py``). Per tier:
   build s and k-means s apart, rows/s appended (segmented), bytes a row
   on the card and on the host, ``cap`` and the overflow, and at nprobe
   8 / 16 / 32 the QPS of batches of 256 (k 10 of a refined pool of 100),
   the device pass and the host refine apart, the peak memory of a batch
   and the size of the gathered ``[32, nprobe·cap, 1024]`` f32 rows.
   Recall@10 against the oracle must reach 0.95 at nprobe 16 on every
   tier; each tier built from 2,048 rows on the card and on the CPU (the
   card's k-means handed to both) must give the same top-10 (rows as sets
   where scores tie, scores to 1e-4). Then ``INDEX_KIND=segmented``
   behind the HTTP service over 6,000 ``encoder_mid`` chunks: the first
   ``/search`` builds the tier on the card, ``POST /ingest`` of a new
   document appends a segment to the SAME index and the document is found
   (each new chunk's own vector finds it through the tier alone),
   ``DELETE`` rebuilds. No K1-K5 launch and no plain version anywhere in
   the phase; the kernel table's rows gain ``launches_capacity_tiers``.
12. training: ``lm_train.make_train_step`` at TinyLlama width (22 x 2048,
   f32 master weights, bf16 compute, seeded init, Adam, clip 1.0), four
   steps on one batch of 4 x S 512 of the copy task at vocabulary 32,000:
   losses finite and falling, step ms, tokens/s, peak memory, and after
   the last phase its device busy share and launches a step from
   ``torch.profiler``. One step of a 2-layer f32 decoder on the card
   against the CPU (loss rtol 1e-5, gradient cosine >= 0.99999 per
   tensor). The JAX scheduler's two acceptance tests on the card, from
   their initial weights (``lm_train.SPEC_INIT``): ``train_copy_lm`` (700
   steps) and ``train_rag_qa_lm`` (800 steps), then ``ContinuousGenerator``
   plain against prompt-lookup waves (gamma 4, window 64) with the JAX
   bars (loss ratio, quote rate, equal tokens, tokens a wave >= 2.0 and
   1.5). The OCR trainers' step stages on the committed fixture
   (``ocr/fixtures/ocr_train.npz.xz``): the JAX digits test's 250 batches
   from scratch (last loss < 0.2 x first, 2 of 3 test strings read), the
   cached recognizer's step stage from the shipped rec weights (200
   steps), the detector at width 16 on the 16 pages (20 steps, falling),
   the cached classifier (100 steps: optax's schedule needs more steps
   than its 50 of warm-up). No K1-K5 launch and no plain version; the
   kernel table's rows gain ``launches_training``.

13. corpus sharding (``intool_rag_tpu_torch/parallel/``) on virtual meshes
   of S entries of the one card (the shards run one after another, so QPS at
   S > 1 forecasts nothing about S cards; with two or more cards a real mesh
   over all of them is added). (a) phase 4's 1M x d1024 store, 256 random
   unit queries, k 10: ``sharded_flat_topk`` (K1 bf16 precise) and
   ``sharded_flat_topk_int8`` (K2 int8r) at S 1, 2 and 4: recall@10 against
   phase 4's dense oracle >= 0.99, and with the exact tail equal to the
   single-device kernels' search (K1 to 1e-4, ids wherever the gap is above
   2e-4; K2 bit-equal); then K1 / K2 on one 4-way shard under
   ``plan_launch``'s plan and the split its merge bound rules out. (b) ``ShardedHybrid`` (int8r, 4 shards, p_max 512)
   over the same million rows with phase 4's Zipf chunks as texts, appended
   in 8 batches; each query aims at a chunk (its rarest terms, together in at
   most 60 chunks, and its embedding at cosine ~0.9). Each retriever's list
   equals the single-device one's (K2 int8r over the same codes: bit-equal;
   a ``BM25Index`` of the same counts: 1e-5, rows wherever no score ties,
   since every chunk has 64 tokens and equal tf ties; both at group width 1
   and the exact tail). Weighted fusion: recall@10 against the exact hybrid
   oracle >= 0.99 (the oracle's tie group at the cut filled by any member)
   and fused scores equal to the single-device hybrid's position by
   position (1e-6), rows wherever no score ties. RRF, which ranks BM25 ties
   in id order: the fusion of the engine's own lists, and the target first
   for >= 0.95 of the queries. (d) ``DCNHybrid`` on a 2 x 2 mesh equal to ``ShardedHybrid``
   on 4 shards over the first 100,000 rows, whose ``save`` / ``load`` round
   trip gives bit-equal results. (c) ``ShardedBitsIndex`` (4 shards) over
   phase 5's 3M x d1024 corpus at nlist 256: recall@10 in the pool of 100
   at nprobe 16 >= 0.95, and at group width 1 with the exact tail the top-10
   of the single-device ``IVFBitsIndex`` of the same centroids and capacity.
   (e) ``sharded_kmeans`` and ``hierarchical_kmeans`` from the same initial
   centroids as single-device Lloyd steps: centroids to 1e-4. (f)
   ``SHARDED_SEARCH=on`` behind the HTTP service on one card takes the
   single-device route and answers 16 requests, one at a time, as ``off``
   does, through K1. Every part fails
   on any plain-version call and unless each per-shard search launched its
   kernel (the counts are exactly shards x searches); QPS, host and device
   ms of a batch, the merge's share and the peak memory are printed with the
   mesh they came from. The kernel table's rows gain ``launches_sharded``.

14. model parallelism on virtual meshes of the one card (with two or more
   cards, over all of them as well). (a) ``shard_decoder_params`` at
   TinyLlama width (random weights), tp 2 and 4: an f32 copy's greedy
   tokens (2 prompts of 128, 32 new) and its ``ContinuousGenerator`` tokens
   (4 prompts, 2 slots) equal the single device's; the bf16 model's
   teacher-forced logits within phase 8's bar (``BF16_CACHE_*``) and its
   greedy tokens equal up to the first position whose single-device top-2
   gap is within the logits' max |diff|; ms a token at tp 1 / 2 / 4, and
   after the last phase the launches a token under ``torch.profiler``.
   (b) ``sp_encode_fn`` at ``bge_m3`` width, B 1, S 8,192, over seq meshes
   of 2 and 4: each embedding at cosine >= 0.999 to the single-device
   forward (the K5 route), an f32 copy at depth 2 within 1e-4 of the
   single-device key-mask route; ms a forward and peak memory. (c) the
   DP+TP step on ``train_mesh`` (data 2, model 2) from phase 7's first run
   (its weights and batch): 3 steps, falling, the first loss within 1e-2
   relative of the single-device step's; the first step's bf16 gradient,
   leaf by leaf, no further from the single-device f32 step's than
   ``MP_GRAD_RATIO`` times the single-device bf16 step's; two runs
   bit-equal, K5 forward / dkv / dq launched layers x shards x groups a
   step (the phase's main path); an f32 copy at depth 2 within 1e-5
   relative a step. No plain version may run; the kernel table's rows gain
   ``launches_model_parallel``.

15. the DeepSeek one-token step's kernels (``kernels/deepseek_decode.cu``) at
   DeepSeek-V2-Lite's widths: each of ``rms_norm``, ``mla_rope_latent``,
   ``mla_decode``, ``moe_router`` and ``moe_combine`` on card tensors (32
   rows; 64 experts, top-6) against its plain version, one launch each; then
   ``_DecodeSteps`` of a V2-Lite-width model cut to two layers (dense, then
   experts), 32 rows over a 2,500-position cache: the graphed step's logits
   within 2e-2 of the layers' own step, and ``DS_STEPS`` steps with every
   launch count set to 0 just before and no plain version run (a replayed
   graph launches without its wrapper: one ``mla_decode`` a layer a step);
   then ``mla_decode`` alone, 32 rows × 16 heads over 2,500 and 8,192
   positions: checked against its plain version (``_rel`` < 1e-2), then µs
   a call (CUDA events, the calls cycling over ``MLA_LAYERS`` caches so each
   reads its bytes from device memory, not L2) against its bound, the
   cache's bytes at 3.35 TB/s, and the plain version's, with the launches of
   the timed calls alone.

Prints the kernel table as one ``{"kernels": [...]}`` line, the card's
name and power limit, and as its last line
``{"ok": true, "device": {...}}``. Exits non-zero, with no result line,
when CUDA is unavailable or any phase fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import faulthandler
import json
import math
import os
import re
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
H100_PEAK = {"bf16": 989e12, "int8": 1979e12, "tf32": 494.7e12, "f32": 67e12}


def log(msg: str) -> None:
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", flush=True)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` in ms over ``iters`` launches. The card
    first sleeps while the host queues every launch, so a call whose host
    side outlasts its kernels is timed by its kernels, not by the host."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)  # about 25 ms of clock cycles
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_wall_ms(fn, iters: int = 100, warmup: int = 5) -> tuple[float, float]:
    """``(host, wall)``: mean ms per call of ``fn()`` over ``iters`` calls in
    a row, the card synchronised before. ``host`` stops the clock when the
    last call returns (the host side alone, while the launch queue has
    room), ``wall`` once the card has finished (host side or device time,
    whichever paces a stream of such calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return 1000 * (t1 - t0) / iters, 1000 * (t2 - t0) / iters


def clocks_under_load(fn, ms_per_call: float, seconds: float = 1.0) -> dict:
    """``fn()`` back to back for about ``seconds`` of device time: its mean
    ms per call over that window, and the card's SM clock (and its maximum)
    and power draw that ``nvidia-smi`` reads half-way through. A kernel that
    draws the card to its power limit runs at a lower clock back to back
    than between host work."""
    import threading

    n = max(2, int(1000 * seconds / ms_per_call))
    sample: dict = {}

    def read() -> None:
        time.sleep(seconds / 2)
        sample["smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    reader = threading.Thread(target=read)
    start.record()
    reader.start()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    reader.join()
    clock, max_clock, power = (float(x) for x in sample["smi"].split(","))
    return {"calls": n, "ms": start.elapsed_time(end) / n, "sm_clock_mhz": clock, "max_sm_clock_mhz": max_clock,
            "power_w": power}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ phase 1


def _ptxas_entries(text: str) -> list[dict]:
    """Registers, spill bytes and static shared memory of every entry
    function in ``-Xptxas=-v`` output."""
    out, name, spill = [], None, 0
    for ln in text.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", ln):
            name, spill = m.group(1), 0
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)):
            spill = int(m.group(1)) + int(m.group(2))
        elif name and (m := re.search(r"Used (\d+) registers", ln)):
            smem = re.search(r"(\d+) bytes smem", ln)
            out.append({"entry": name, "registers": int(m.group(1)), "spill_bytes": spill,
                        "static_smem": int(smem.group(1)) if smem else 0})
            name = None
    return out


def _tensor_core_kernels(text: str) -> dict:
    """K1/K2's tensor-core instantiations by variant and query-tile width:
    registers, spill bytes and the TMA ring's dynamic shared memory."""
    from intool_rag_tpu_torch.ops import flat_fused as ff

    names = {kind: name for name, (kind, _) in ff._KINDS.items()}
    lib = ff._lib()
    out: dict = {}
    for e in _ptxas_entries(text):
        if m := re.search(r"partial_topk_kernelILi(\d+)ELi(\d+)E", e["entry"]):
            kind, width = int(m.group(1)), int(m.group(2))
            out.setdefault(names[kind], {})[width] = {
                "registers": e["registers"], "spill_bytes": e["spill_bytes"],
                "smem_bytes": e["static_smem"] + lib.flat_partial_topk_smem(kind, width)}
    return out


def _k5_kernels(name: str, text: str) -> dict:
    """K5's entries in ``flash_attention.cu`` (forward, with and without the
    saved residuals) or ``flash_attention_bwd.cu`` (dkv, dq): registers,
    spill bytes and shared memory (the TMA rings of the bf16 kernels and of
    the f32 backward are dynamic). Fails on a spill or a compiler warning (an
    ignored setmaxnreg shows as one). ptxas reports a wgmma pipeline it
    serialized as an info line, with its reason: that fails the forward and
    the f32 backward (dkv, dq), and is printed for the bf16 backward (dkv
    bf16 is serialized: ROADMAP.md Queue B items 1-2)."""
    from intool_rag_tpu_torch.ops import flash_attention as fa

    if name == "flash_attention.cu":
        pattern = r"flash_(bf16|f32)_kernelILb([01])E"
        label = lambda m: f"K5 {m.group(1)}{' save' if m.group(2) == '1' else ''}"
        dyn = lambda m: fa._lib().flash_attention_smem() if m.group(1) == "bf16" else fa._lib().flash_attention_f32_smem()
        must_pipeline = lambda k: True
    else:
        lib = fa._lib_bwd()
        pattern = r"flash_(dkv|dq)_(bf16|f32)_kernel"
        label = lambda m: f"K5 {m.group(1)} {m.group(2)}"
        dyn = lambda m: (lib.flash_attention_bwd_smem() if m.group(2) == "bf16"
                         else lib.flash_attention_bwd_f32_smem(int(m.group(1) == "dkv")))
        must_pipeline = lambda k: k.endswith("f32")
    out = {}
    for e in _ptxas_entries(text):
        if m := re.search(pattern, e["entry"]):
            out[label(m)] = {"registers": e["registers"], "spill_bytes": e["spill_bytes"],
                             "smem_bytes": e["static_smem"] + dyn(m)}
    for ln in text.splitlines():
        if (m := re.search(r"wgmma\.mma_async instructions are serialized due to (.*) in the function '([^']+)'", ln)) \
                and (e := re.search(pattern, m.group(2))):
            out.setdefault(label(e), {})["wgmma_serialized"] = m.group(1)
    log(f"built {name}: K5 (registers, spill bytes, shared memory): {json.dumps(out)}")
    warnings = sorted({ln.strip() for ln in text.splitlines() if "warning" in ln.lower()})
    spilled = [k for k, e in out.items() if e["spill_bytes"]]
    serialized = [k for k, e in out.items() if "wgmma_serialized" in e and must_pipeline(k)]
    if warnings or spilled or serialized or len(out) != 4:
        raise AssertionError(f"K5 kernels of {name}: warnings {warnings}, spills {spilled}, serialized wgmma "
                             f"{serialized}, entries {sorted(out)}")
    return out


def _k3_kernels(text: str) -> dict:
    """K3's entries in ``bits_scan.cu`` (the scan per plane width, the plan):
    registers, spill bytes and shared memory (the scan's ring and query tiles
    are dynamic). Fails on a spill or a compiler warning."""
    from intool_rag_tpu_torch.ops import bits_scan as bs

    out = {}
    for e in _ptxas_entries(text):
        if m := re.search(r"bits_scan_kernelILi(\d+)E", e["entry"]):
            d = 128 * int(m.group(1))
            out[f"K3 scan D {d}"] = {"registers": e["registers"], "spill_bytes": e["spill_bytes"],
                                     "smem_bytes": e["static_smem"] + bs._lib().bits_scan_smem(d)}
        elif "bits_plan_kernel" in e["entry"]:
            out["K3 plan"] = {"registers": e["registers"], "spill_bytes": e["spill_bytes"],
                              "smem_bytes": e["static_smem"]}
    for ln in text.splitlines():  # printed: a scan whose wgmma pipeline ptxas serialized
        if (m := re.search(r"wgmma\.mma_async instructions are serialized due to (.*) in the function '([^']+)'", ln)) \
                and (e := re.search(r"bits_scan_kernelILi(\d+)E", m.group(2))):
            out[f"K3 scan D {128 * int(e.group(1))}"]["wgmma_serialized"] = m.group(1)
    log(f"built bits_scan.cu: K3 (registers, spill bytes, shared memory): {json.dumps(out)}")
    warnings = sorted({ln.strip() for ln in text.splitlines() if "warning" in ln.lower()})
    spilled = [k for k, e in out.items() if e["spill_bytes"]]
    if warnings or spilled or len(out) != 1 + len(bs.KERNEL_DIMS):
        raise AssertionError(f"K3 kernels: warnings {warnings}, spills {spilled}, entries {sorted(out)}")
    return out


def phase_build(state: dict) -> None:
    from intool_rag_tpu_torch.kernels import build

    state["card"] = card_line()
    log(f"card: {state['card']}")
    t0 = time.perf_counter()
    for source in build.SOURCES:  # the first load builds every missing library, all at once
        build.load(source)
    state["build_s"] = time.perf_counter() - t0
    for name, text in build.BUILD_LOG.items():
        if name == "flat_partial_topk.cu":
            tc = _tensor_core_kernels(text)
            log(f"built {name}: K1/K2 on the tensor cores (registers, spill bytes, shared memory "
                f"per query-tile width): {json.dumps(tc)}")
            rest = [e for e in _ptxas_entries(text) if "partial_topk_kernelI" not in e["entry"]]
            log(f"built {name}: other entries {json.dumps(rest)}")
            warnings = sorted({ln.strip() for ln in text.splitlines() if "warning" in ln.lower()})
            if warnings:  # e.g. a setmaxnreg that ptxas ignored
                raise AssertionError(f"{name}: compiler warnings {warnings}")
            spilled = {v: w for v, widths in tc.items() for w, e in widths.items() if e["spill_bytes"]}
            if spilled or len(tc) != 8:
                raise AssertionError(f"K1/K2 tensor-core kernels: spills {spilled}, variants {sorted(tc)}")
            state["tensor_core_kernels"] = tc
            continue
        if name in ("flash_attention.cu", "flash_attention_bwd.cu"):
            state.setdefault("k5_kernels", {}).update(_k5_kernels(name, text))
            continue
        if name == "bits_scan.cu":
            state["k3_kernels"] = _k3_kernels(text)
            continue
        kept = [ln.split("ptxas info    : ")[-1] for ln in text.splitlines()
                if "registers" in ln or "smem" in ln or "spill" in ln]
        log(f"built {name}: " + " | ".join(kept))
    log(f"kernel build {state['build_s']:.1f} s")


# ------------------------------------------------------------------ phase 2

K2_VARIANTS = {  # name -> (q2, residual)
    "int8": (False, False),
    "int8+q2": (True, False),
    "int8+c2": (False, True),
    "int8r": (True, True),
}
# (n, valid_n, d, query counts, group widths): valid_n inside a 128-row tile
# of the last block; Q 300 takes more than one query tile (two or five) and
# Q 3 / 64 at group_l 32 split each block across CTAs. The last shape is the
# phase-3 service store (50k rows, d 384) at batch 1, 8 and 16: every launch
# there splits the blocks, and valid_n falls inside a split.
CHECK_SHAPES = [
    (65_536, 64_536, 384, (3, 64, 256, 300), (8, 32)),
    (65_536, 64_536, 1024, (3, 64, 256, 300), (8, 32)),
    (53_248, 50_000, 384, (1, 8, 16), (8, 32)),
]
# near-duplicate queries (corpus rows below valid_n plus noise of NEAR_NOISE,
# renormalised: scores about 1, where a one-sided rounding error of K1 f32's
# tf32 products would add up): query counts by (N, D), at D 384 and D 1024
NEAR_QUERIES = {(65_536, 384): (16, 256), (65_536, 1024): (16, 256)}
NEAR_NOISE = 1e-3


def _unit(gen, shape, dev):
    x = torch.randn(shape, generator=gen, device=dev)
    return x / x.norm(dim=1, keepdim=True)


def _near_duplicates(gen, corpus, valid_n, q):
    """``q`` queries, each a distinct corpus row below ``valid_n`` plus
    Gaussian noise of ``NEAR_NOISE``, renormalised."""
    rows = torch.randperm(valid_n, generator=gen, device=corpus.device)[:q]
    x = corpus[rows] + NEAR_NOISE * torch.randn((q, corpus.shape[1]), generator=gen, device=corpus.device)
    return x / x.norm(dim=1, keepdim=True)


def _operands(queries, cb, ch, c32, c1, c2, cs) -> dict[str, tuple]:
    """Kernel operands of every K1/K2 variant for these queries: K1 takes
    ``(q_hi, q_lo, corpus)``, K2 ``(q1, q2, c1, c2, cscale)``."""
    from intool_rag_tpu_torch.ops import flat_fused as ff

    q_hi, q_lo = ff.split_query_bf16(queries)
    q1, q2, _ = ff.split_query_int8(queries)
    ops = {
        "K1 bf16 precise": (q_hi, q_lo, cb),
        "K1 bf16": (q_hi, None, cb),
        "K1 f16": (queries.half().contiguous(), None, ch),
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
        cb, ch = corpus.bfloat16().contiguous(), corpus.half().contiguous()
        c1, c2, cs = quantize_int8_residual(corpus)
        near = NEAR_QUERIES.get((n, d), ())
        batches = [(f"Q {q}", _unit(gen, (q, d), dev)) for q in query_counts] + [
            (f"Q {q} near-duplicate", _near_duplicates(gen, corpus, valid_n, q)) for q in near]
        for what, queries in batches:
            ops = _operands(queries, cb, ch, corpus, c1, c2, cs)
            for g in widths:
                for name, args in ops.items():
                    kout = _kernel(name, args, g, valid_n)
                    torch.cuda.synchronize()
                    err = _compare(name, args, kout, _plain(name, args, g, valid_n))
                    errs[name] = max(errs.get(name, 0.0), err)
                    checks += 1
                    if name.startswith("K2") or name == "K1 f32":  # a repeated run is bit-equal to the first
                        again = _kernel(name, args, g, valid_n)
                        if not (torch.equal(again[0], kout[0]) and torch.equal(again[1], kout[1])):
                            raise AssertionError(f"{name} at {what}, N {n}, D {d}, group_l {g}: repeat differs")
        del corpus, cb, ch, c1, c2, cs
    torch.cuda.empty_cache()
    plans = 0
    for *shape, every_tile in [(*c, None) for c in K3_CHECKS] + K3_PLAN_CHECKS:
        args, kw = _k3_inputs(gen, *shape, dev, every_tile=every_tile)
        kout = _k3_kernel(args, kw)
        again = _k3_kernel(args, kw)
        torch.cuda.synchronize()
        if not (torch.equal(again[0], kout[0]) and torch.equal(again[1], kout[1])):
            raise AssertionError(f"K3 at {shape}: a repeated call differs")
        errs["K3"] = max(errs.get("K3", 0.0), _compare_k3(args, kw, kout, _k3_plain(args, kw)))
        checks += 1
        plans += _check_k3_plan(args[3])
        del args, kout, again
        torch.cuda.empty_cache()
    log(f"phase 2: K3 repeats bit-equal on {len(K3_CHECKS) + len(K3_PLAN_CHECKS)} shapes; the kernel's plan "
        f"equals scan_plan_reference on {plans}")
    with_bad_width = _k3_inputs(gen, 128, 128, 1, 4, 2, 8, 8, dev)
    try:  # a plane width the kernel cannot tile raises; it never takes the plain version
        bad = list(with_bad_width[0])
        bad[0], bad[1] = bad[0][:, :64].contiguous(), bad[1][:, :8].contiguous()
        _k3_kernel(bad, with_bad_width[1])
    except ValueError as exc:
        log(f"phase 2: D=64 refused as expected: {exc}")
    else:
        raise AssertionError("K3 accepted D=64, which it cannot tile")
    errs["K4"] = _check_k4(dev)
    checks += 1
    k5 = _check_k5(dev)
    errs.update({"K5 f32": k5["float32"], "K5 bf16": k5["bfloat16"]})
    state["k5_row_rel_err"] = k5["bfloat16 row-relative"]
    errs.update(_check_k5_backward(dev))
    state["max_abs_err"] = errs
    log(f"phase 2: {checks} kernel-vs-plain checks passed; max |err| {json.dumps(errs)}")


# (d, block_n, blocks_per_list, nlist, nprobe, queries, group_l); the last
# eight are the shapes the main paths give the kernel: the phase-3 service
# store at batch 8 and 16, and the phase-5 capacity run at nprobe 8/16/32
# on a batch of 256 and on the 64 oracle queries
K3_CHECKS = [
    (128, 128, 2, 24, 8, 64, 8),
    (128, 128, 2, 24, 1, 8, 1),
    (256, 128, 3, 24, 16, 64, 32),
    (256, 1024, 1, 20, 8, 8, 8),
    (384, 128, 2, 24, 16, 256, 1),
    (384, 1024, 2, 20, 8, 64, 32),
    (1024, 128, 2, 24, 8, 256, 8),
    (1024, 1024, 2, 20, 16, 64, 1),
    (1024, 1024, 1, 20, 1, 8, 32),
    (384, 1024, 1, 1024, 64, 8, 8),
    (384, 1024, 1, 1024, 64, 16, 8),
    (1024, 1024, 13, 256, 8, 256, 8),
    (1024, 1024, 13, 256, 16, 256, 8),
    (1024, 1024, 13, 256, 32, 256, 8),
    (1024, 1024, 13, 256, 8, 64, 8),
    (1024, 1024, 13, 256, 16, 64, 8),
    (1024, 1024, 13, 256, 32, 64, 8),
]


# (d, block_n, blocks_per_list, nlist, nprobe, queries, group_l, list every
# tile probes): list 0 probed by all 32 tiles, more than the plan's group cap,
# so its blocks are split across items; list 1, all empty, probed by every tile
K3_PLAN_CHECKS = [
    (1024, 1024, 2, 20, 8, 256, 8, 0),
    (384, 256, 3, 24, 6, 128, 1, 0),
    (384, 1024, 1, 64, 16, 64, 8, 1),
]


def _check_k3_plan(probe_blocks) -> int:
    """The kernel's plan of these probes (its groups and pair order) against
    scan_plan_reference, bit for bit; 1 if held, 0 where the pairs exceed one
    plan (the kernel plans them in rectangles)."""
    from intool_rag_tpu_torch.ops.bits_scan import scan_plan, scan_plan_reference

    if probe_blocks.numel() > 2048:
        return 0
    (kg, ko), (pg, po) = scan_plan(probe_blocks), scan_plan_reference(probe_blocks)
    if not (torch.equal(kg, pg) and torch.equal(ko, po)):
        raise AssertionError(f"K3 plan of {tuple(probe_blocks.shape)} probes differs from scan_plan_reference")
    return 1


def _k3_inputs(gen, d, block_n, bpl, nlist, nprobe, q, group_l, dev, empty_frac=0.2, every_tile=None):
    """A random list-major store (a fifth of the slots empty, list 1 all
    empty and probed by tile 0, or by every tile where ``every_tile`` is 1)
    with a random probe table (list ``every_tile`` in every tile's probes), as
    ``(qb, codes, scales, probe_blocks, c_sel)`` and the scan's statics."""
    n_blocks = nlist * bpl
    codes = torch.randint(0, 256, (n_blocks * block_n, d // 8), generator=gen, device=dev,
                          dtype=torch.uint8)
    scales = 0.05 + 0.1 * torch.rand((n_blocks, 8, block_n), generator=gen, device=dev)
    empty = torch.rand((n_blocks, block_n), generator=gen, device=dev) < empty_frac
    empty[bpl : 2 * bpl] = True
    scales[:, 0, :] = torch.where(empty, -1.0, scales[:, 0, :])
    draw = torch.rand((q // 8, nlist), generator=gen, device=dev)
    if every_tile is not None:
        draw[:, every_tile] = -1.0  # first in every tile's probes
    lists = draw.argsort(dim=1)[:, :nprobe]
    lists[0, 0] = 1
    probe_blocks = (lists * bpl).to(torch.int32).contiguous()
    c_sel = torch.randn((q, nprobe), generator=gen, device=dev)
    qb = _unit(gen, (q, d), dev).bfloat16().contiguous()
    return (qb, codes, scales, probe_blocks, c_sel), dict(
        blocks_per_list=bpl, block_n=block_n, group_l=group_l)


def _k3_kernel(args, kw):
    from intool_rag_tpu_torch.ops.bits_scan import bits_scan

    return bits_scan(*args, **kw)


def _k3_plain(args, kw):
    from intool_rag_tpu_torch.ops.bits_scan import bits_scan_reference

    return bits_scan_reference(*args, **kw)


def _compare_k3(args, kw, kout, pout) -> float:
    """Max |value diff| of K3's candidates against the plain version's.
    Raises unless the -inf pattern is equal, values agree to rtol 2e-5 /
    atol 1e-5 (f32 sums of bf16 products in another order), an all -inf
    group reports g = 0, and every other id that differs is the kernel's
    pick within 1e-5 of the group max."""
    (kv, ki), (pv, pi) = kout, pout
    finite = torch.isfinite(pv)
    if not torch.equal(finite, torch.isfinite(kv)):
        raise AssertionError("K3: -inf pattern differs from the plain version")
    delta = (kv[finite] - pv[finite]).abs()
    err = delta.max().item() if delta.numel() else 0.0
    if (delta > 1e-5 + 2e-5 * pv[finite].abs()).any():
        raise AssertionError(f"K3 value error {err} beyond rtol 2e-5 / atol 1e-5")
    diff = ki != pi
    if (diff & ~finite).any():
        raise AssertionError("K3: an all -inf group does not report its first slot")
    if diff.any():
        block_n, lw = kw["block_n"], kw["block_n"] // kw["group_l"]
        v1, i1 = _k3_plain(args, {**kw, "group_l": 1})  # every slot's score
        qi, col = diff.nonzero(as_tuple=True)
        col1 = (col // lw) * block_n + ki[qi, col].long() % block_n
        if not torch.equal(i1[qi, col1], ki[qi, col]):
            raise AssertionError("K3: a differing id lies outside its block")
        gap = (pv[qi, col] - v1[qi, col1]).abs().max().item()
        if gap > 1e-5:
            raise AssertionError(f"K3: id differs at within-group gap {gap}")
    return err


def _check_k4(dev) -> float:
    """K4 against its plain version. The two draw from different random
    streams, so the checks are those that do not depend on the stream.
    Returns the largest deviation of the 64-seed mean from x."""
    from intool_rag_tpu_torch.ops.quant import (
        dequantize_int8, quantize_int8_stochastic, quantize_int8_stochastic_reference,
    )

    gen = torch.Generator(device=dev).manual_seed(3)
    for shape in ((4096, 1024), (257, 1000), (64, 384), (250_000, 1024)):
        x = torch.randn(shape, generator=gen, device=dev)
        x = x * (0.5 + torch.rand((shape[0], 1), generator=gen, device=dev))
        q, scale = quantize_int8_stochastic(x, seed=11)
        torch.cuda.synchronize()
        pq, p_scale = quantize_int8_stochastic_reference(x, seed=11)
        if not torch.equal(scale, p_scale):
            raise AssertionError(f"K4 {shape}: scales are not bit-equal to the plain version's")
        scaled = (x / scale[:, None]).clamp(-127.0, 127.0)
        lo = torch.floor(scaled)
        qf = q.float()
        if not ((qf == lo) | (qf == (lo + 1).clamp(max=127.0))).all():
            raise AssertionError(f"K4 {shape}: a code is neither floor nor floor+1")
        if not torch.equal(q, quantize_int8_stochastic(x, seed=11)[0]):
            raise AssertionError(f"K4 {shape}: the same seed gave another output")
        if torch.equal(q, quantize_int8_stochastic(x, seed=12)[0]):
            raise AssertionError(f"K4 {shape}: another seed gave the same output")
        frac = (scaled - lo).double()
        n = frac.numel()
        sigma = (2.0 * (frac * (1.0 - frac)).sum()).sqrt().item() / n
        up_kernel = (qf > lo).double().mean().item()
        up_plain = (pq.float() > lo).double().mean().item()
        if abs(up_kernel - up_plain) > 3.0 * sigma:
            raise AssertionError(
                f"K4 {shape}: rounding-up rate {up_kernel} vs plain {up_plain}, 3 sigma = {3 * sigma}")
        log(f"phase 2 K4 {shape}: up-rate kernel {up_kernel:.6f} plain {up_plain:.6f} "
            f"expected {frac.mean().item():.6f} (sigma {sigma:.2e})")
        del x, q, pq, scaled, lo, qf, frac
    # unbiased: the 64-seed mean of the dequantized output is within 0.35 steps of x
    x = torch.linspace(-1, 1, 4 * 128, device=dev).reshape(4, 128)
    acc = torch.zeros_like(x)
    for seed in range(64):
        acc += dequantize_int8(*quantize_int8_stochastic(x, seed=seed))
    dev_max = (acc / 64 - x).abs().max().item()
    if dev_max >= 0.35 / 127.0:
        raise AssertionError(f"K4: 64-seed mean off by {dev_max} >= 0.35 steps ({0.35 / 127.0})")
    torch.cuda.empty_cache()
    return dev_max


# (dtype, B, H, S) of the K5 checks; every segment layout of _segment_layouts runs at
# each. The last four are the shapes the ingest runs of phase 6 give the kernel (its
# fifth, B 4 at S 8192, is checked one head at a time below).
K5_CHECKS = [
    ("float32", 1, 16, 128), ("float32", 3, 6, 1024), ("float32", 1, 6, 2048),
    ("bfloat16", 3, 16, 128), ("bfloat16", 1, 6, 1024), ("bfloat16", 3, 16, 1024),
    ("bfloat16", 1, 16, 2048), ("bfloat16", 3, 6, 2048),
    ("bfloat16", 2, 16, 2048), ("bfloat16", 4, 16, 1024), ("bfloat16", 4, 16, 2048),
    ("bfloat16", 4, 16, 4096),
]
K5_ATOL = {"float32": 2e-5, "bfloat16": 2e-2}  # on unit-variance q, k, v
# bf16 forward, besides K5_ATOL: per query row, max |diff| within K5_FWD_REL_BF16 of the
# row's largest |value| (K5_ATOL alone is about one output value at long rows: |o| is about
# sqrt(e / L), 0.02 at 6,500 keys). The kernel rounds p to bf16 before it divides by the
# row's sum (and relative to the running max), the plain version after, so each p rounds
# on its own in the two: about 2^-8.8 of the row's rms a value, to some 5 sigma over a
# check's millions of values; the output's own rounding adds one bf16 step (up to 2^-7 of
# the value). Four steps of 2^-8 of the row's largest |value| hold both; a kernel 20 % off
# is 13 times beyond. Rows whose largest |value| is below K5_FWD_ROW_FLOOR are held to the floor.
K5_FWD_REL_BF16 = 2.0 ** -6
K5_FWD_ROW_FLOOR = 1e-4


def _row_rel_err(out: torch.Tensor, want: torch.Tensor) -> float:
    """The largest, over query rows, of max |out - want| over the row's 64
    values divided by the row's largest |want| (at least K5_FWD_ROW_FLOOR)."""
    diff = (out.float() - want.float()).abs().amax(-1)
    return (diff / want.float().abs().amax(-1).clamp_min(K5_FWD_ROW_FLOOR)).max().item()


def _segment_layouts(rng: np.random.Generator, b: int, s: int) -> dict[str, np.ndarray]:
    """Segment-id layouts ``[b, s]`` i32 the encoder can hand to K5: one
    segment; the 0/1 mask of rows with a padded tail; packed rows of 1..12
    segments with pads; 61-token segments, which straddle every 64-key tile
    boundary and leave whole key tiles masked for most rows; the packed
    layout with row 0 all pads."""
    pos = np.arange(s)[None, :]
    tail = (pos < rng.integers(1, s + 1, size=(b, 1))).astype(np.int32)
    packed = np.zeros((b, s), np.int32)
    for r in range(b):
        p = int(rng.integers(1, 13))
        used = int(rng.integers(max(p, s // 2), s + 1))
        cuts = np.sort(rng.choice(np.arange(1, used), size=p - 1, replace=False)) if p > 1 else []
        bounds = [0, *cuts, used]
        for i in range(p):
            packed[r, bounds[i] : bounds[i + 1]] = i + 1
    straddle = np.broadcast_to(pos // 61 + 1, (b, s)).astype(np.int32).copy()
    straddle[:, s - s // 10 :] = 0
    pads = packed.copy()
    pads[0] = 0
    return {"one": np.ones((b, s), np.int32), "mask": tail, "packed": packed,
            "straddle": straddle, "all-pad row": pads}


def _no_key_rows(seg: torch.Tensor) -> torch.Tensor:
    """seg_q for the keys' ``seg``: every 37th row given an id that no key
    carries, so it averages v over every key."""
    pos = torch.arange(seg.shape[1], device=seg.device)
    return torch.where(pos % 37 == 5, seg.max() + 1, seg).to(torch.int32).contiguous()


def _check_k5(dev) -> dict[str, float]:
    """K5 forward against its plain version on the card: max |diff| per
    dtype, and bf16's largest row-relative diff (``_row_rel_err``). Raises
    beyond ``K5_ATOL`` or, in bf16, ``K5_FWD_REL_BF16``. Every check (bf16
    and f32) runs each variant (inference, and with the saved residuals)
    twice, bit-equal, with the kernels' tile counts on: each CTA's count
    must equal the skip rule's (``computed_tiles`` at the forward's tiles of
    that dtype, with ``m`` from that same launch). S 8192 is compared one
    head at a time, so the plain version's logits stay at 1.1 GB."""
    from intool_rag_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(5)
    gen = torch.Generator(device=dev).manual_seed(5)
    errs = {"float32": 0.0, "bfloat16": 0.0, "bfloat16 row-relative": 0.0}
    checks = 0

    def run(q, k, v, seg_q, seg_kv):
        """Both variants (inference, saved residuals), each twice (bit-equal); returns their outputs."""
        out = fa.flash_attention_segments(q, k, v, seg_q, seg_kv, 0.125)
        saved = fa._forward_cuda(q, k, v, seg_q, seg_kv, 0.125, True)
        again = (fa.flash_attention_segments(q, k, v, seg_q, seg_kv, 0.125),
                 *fa._forward_cuda(q, k, v, seg_q, seg_kv, 0.125, True))
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip((out, *saved), again)):
            raise AssertionError(f"K5 {q.dtype} {tuple(q.shape)}: two runs differ")
        return out, saved[0]

    def hold(name, q, out, want, heads=slice(None)):
        nonlocal checks
        dt = str(q.dtype).split(".")[-1]
        err = (out[:, heads].float() - want.float()).abs().max().item()
        rel = _row_rel_err(out[:, heads], want) if dt == "bfloat16" else 0.0
        if not (torch.isfinite(out[:, heads].float()).all() and err <= K5_ATOL[dt] and rel <= K5_FWD_REL_BF16):
            raise AssertionError(f"K5 {dt} {tuple(q.shape)} layout {name!r}: max |diff| {err} (bar {K5_ATOL[dt]}), "
                                 f"row-relative {rel} (bar {K5_FWD_REL_BF16})")
        errs[dt] = max(errs[dt], err)
        if dt == "bfloat16":
            errs["bfloat16 row-relative"] = max(errs["bfloat16 row-relative"], rel)
        checks += 1

    def compare(name, q, k, v, seg_q, seg_kv):
        _counted_fwd_tiles_share(q, k, v, seg_q, seg_kv, name)
        outs = run(q, k, v, seg_q, seg_kv)
        want = fa.flash_attention_plain(q, k, v, seg_q, seg_kv, 0.125)
        for out in outs:
            hold(name, q, out, want)

    for dt, b, h, s in K5_CHECKS:
        dtype = getattr(torch, dt)
        for name, seg_np in _segment_layouts(rng, b, s).items():
            # the encoder's layout: [B, S, H*64] projections viewed as [B, H, S, 64]
            q, k, v = (torch.randn((b, s, h, 64), generator=gen, device=dev).to(dtype).transpose(1, 2)
                       for _ in range(3))
            seg = torch.as_tensor(seg_np, device=dev)
            compare(name, q, k, v, seg, seg)
        # rows whose segment id no key carries average v over every key
        compare("rows no key matches", q, k, v, _no_key_rows(seg), seg)
        for name, (seg_q, seg_kv) in _skip_layouts(b, s).items():  # the tile skip's edges
            compare(name, q, k, v, torch.as_tensor(seg_q, device=dev), torch.as_tensor(seg_kv, device=dev))
    for dt in ("float32", "bfloat16"):
        seg_np = _segment_layouts(rng, 4, 8192)
        for name in ("mask", "packed"):
            q, k, v = (torch.randn((4, 16, 8192, 64), generator=gen, device=dev).to(getattr(torch, dt))
                       for _ in range(3))
            seg = torch.as_tensor(seg_np[name], device=dev)
            _counted_fwd_tiles_share(q, k, v, seg, seg, f"S 8192 {name}")
            outs = run(q, k, v, seg, seg)
            for head in (0, 7, 15):
                hs = slice(head, head + 1)
                want = fa.flash_attention_plain(q[:, hs], k[:, hs], v[:, hs], seg, seg, 0.125)
                for out in outs:
                    hold(f"S 8192 {name} head {head}", q, out, want, hs)
                del want
            del q, k, v, outs
    # k and v expanded over the heads (a zero stride): the bf16 kernel reads copies, the same bits
    q = torch.randn((1, 256, 4, 64), generator=gen, device=dev).to(torch.bfloat16).transpose(1, 2)
    kv = torch.randn((1, 1, 256, 64), generator=gen, device=dev).to(torch.bfloat16).expand(1, 4, 256, 64)
    seg = torch.ones((1, 256), dtype=torch.int32, device=dev)
    if not torch.equal(fa.flash_attention_segments(q, kv, kv, seg, seg, 0.125),
                       fa.flash_attention_segments(q, kv.contiguous(), kv.contiguous(), seg, seg, 0.125)):
        raise AssertionError("K5 bf16: expanded k, v give another output than their copies")
    for bad, why in (((1, 2, 192, 64), "S % 128"), ((1, 2, 128, 32), "head dim")):
        x = torch.zeros(bad, device=dev, dtype=torch.bfloat16)
        try:  # an unsupported shape raises; it never takes the plain version
            fa.flash_attention_segments(x, x, x, *(torch.zeros(bad[0], bad[2], dtype=torch.int32, device=dev),) * 2, 0.125)
        except ValueError:
            continue
        raise AssertionError(f"K5 accepted a shape it cannot tile ({why})")
    torch.cuda.empty_cache()
    log(f"phase 2 K5: {checks} kernel-vs-plain checks passed, bf16 repeats bit-equal and tile counts "
        f"equal to the skip rule's; max |err| {json.dumps(errs)}")
    return errs


# K5's backward kernels against the plain backward, on unit-variance q, k, v, do.
# f32: the two sum up to 8,192 f32 products per value in another order. bf16:
# p and ds are rounded to bf16 in both, but from exponentials that differ in
# their last f32 bits, so a few of them round the other way, and each gradient
# is rounded to bf16 once more: two bf16 steps (2^-7) of the largest gradient.
K5_BWD_ATOL_F32 = 5e-5
K5_BWD_REL_BF16 = 2.0 ** -7


def _skip_layouts(b: int, s: int) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """(seg_q, seg_kv) layouts at the edges of the bf16 kernels' tile
    skip: a query row whose id no key carries, inside a query tile whose id
    range meets no other key tile (ids 2, 4, 6, ... in runs of 100, row 5
    given 3), so only that row keeps the tile (the forward walks the skipped
    tiles for it); and interleaved, non-monotonic ids that differ between
    queries (runs of 80) and keys (runs of 96), with rows no key matches
    among them."""
    pos = np.arange(s)[None, :]
    even = np.broadcast_to(2 * (pos // 100 + 1), (b, s)).astype(np.int32)
    odd_row = even.copy()
    odd_row[:, 5] = 3
    kv_ids = np.array([5, 1, 6, 2, 7, 3, 8, 4, 9], np.int32)
    q_ids = np.array([1, 5, 2, 6, 3, 7, 4, 8, 10, 9], np.int32)
    seg_kv = np.broadcast_to(kv_ids[(pos // 96) % len(kv_ids)], (b, s)).astype(np.int32)
    seg_q = np.broadcast_to(q_ids[(pos // 80) % len(q_ids)], (b, s)).astype(np.int32)
    return {"no key in a skipped tile": (odd_row, even.copy()), "interleaved": (seg_q.copy(), seg_kv.copy())}


def _tile_counts(launch, shape: tuple[int, int, int], rows: int = 128) -> torch.Tensor:
    """Runs ``launch`` with the K5 kernels' tile counts on (``count_tiles``):
    every CTA reports the streamed tiles it loaded and that two of its
    consumers walked. Returns the counts, ``[B, H, S/rows, 3]`` (``rows``:
    the rows a CTA owns, ``cta_rows``)."""
    from intool_rag_tpu_torch.ops import flash_attention as fa

    b, h, s = shape
    counts = torch.full((b, h, s // rows, 3), -1, dtype=torch.int32, device=DEVICE)
    fa.count_tiles(counts)
    try:
        launch()
        torch.cuda.synchronize()
    finally:
        fa.count_tiles(None)
    return counts


def _hold_tile_counts(counts: torch.Tensor, tiles: torch.Tensor, what: str, label: str) -> float:
    """Fails unless every count equals the skip rule's plain model ``tiles``
    (``computed_tiles`` at kernel ``what``'s tiles); returns the share of the
    (query tile, key tile) pairs that the kernel computed, as it counted
    them."""
    want = (tiles.sum(2) if what.startswith("dkv") else tiles.sum(3)).int()  # per CTA: its keys (dkv) or queries
    if not torch.equal(counts, want[..., None].expand(-1, -1, -1, 3)):
        bad = (counts != want[..., None]).nonzero()[:4].tolist()
        raise AssertionError(f"{label}: the kernel's tile counts differ from the skip rule's at "
                             f"(b, h, cta, role) {bad}")
    return counts[..., 0].sum().item() / tiles.numel()


def _counted_tiles_share(q, k, v, seg_q, seg_kv, l, m, do, di, what: str) -> float:
    """One launch of backward kernel ``what`` (``dkv`` or ``dq``, at q's
    type: bf16 or f32, each at its own tiles) with its tile counts on, held
    against the skip rule; returns the share of tiles it computed, as it
    counted them."""
    from intool_rag_tpu_torch.ops import flash_attention as fa

    b, h, s, _ = q.shape
    kernel = fa.flash_attention_dkv if what == "dkv" else fa.flash_attention_dq
    key = fa.tiles_key(what, q.dtype)
    counts = _tile_counts(lambda: kernel(q, k, v, seg_q, seg_kv, l, m, do, di, 0.125), (b, h, s),
                          fa.cta_rows(what, q.dtype))
    return _hold_tile_counts(counts, fa.computed_tiles(seg_q, seg_kv, m, *fa.TILES[key]), key,
                             f"K5 {what} {'bf16' if q.dtype == torch.bfloat16 else 'f32'} {(b, h, s)}")


def _counted_fwd_tiles_share(q, k, v, seg_q, seg_kv, label: str) -> float:
    """The forward (at q's type: bf16 or f32, each at its own tiles) with its
    tile counts on: the launch that saves l and m is held against the skip
    rule with that launch's own m, and the inference launch must count the
    same tiles. Returns the share of tiles computed, as the kernel counted
    them."""
    from intool_rag_tpu_torch.ops import flash_attention as fa

    b, h, s, _ = q.shape
    key, rows = fa.tiles_key("fwd", q.dtype), fa.cta_rows("fwd", q.dtype)
    what = f"K5 forward {'bf16' if q.dtype == torch.bfloat16 else 'f32'} {(b, h, s)} {label!r}"
    saved = {}
    counts = _tile_counts(lambda: saved.update(m=fa._forward_cuda(q, k, v, seg_q, seg_kv, 0.125, True)[2]),
                          (b, h, s), rows)
    tiles = fa.computed_tiles(seg_q, seg_kv, saved["m"], *fa.TILES[key])
    share = _hold_tile_counts(counts, tiles, key, what)
    inference = _tile_counts(lambda: fa.flash_attention_segments(q, k, v, seg_q, seg_kv, 0.125), (b, h, s), rows)
    if not torch.equal(inference, counts):
        raise AssertionError(f"{what}: the inference launch counts other tiles")
    return share


def _check_k5_backward(dev) -> dict[str, float]:
    """K5 dkv and dq against ``flash_attention_backward_plain`` on the card,
    both given the kernel forward's own ``o, l, m``: max |diff| per kernel
    variant. Also holds the forward's saved ``l, m`` against the plain
    version's, takes the gradient once through ``torch.autograd`` (the
    Function), and runs every backward twice: the runs must be bit-equal.
    Every kernel's own tile counts (bf16 and f32, each at its tiles) must
    equal the skip rule's on every layout. S 8192 is compared one head at a
    time."""
    from intool_rag_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(8)
    gen = torch.Generator(device=dev).manual_seed(8)
    errs: dict[str, float] = {}
    checks = 0

    def strided(shape, dtype):  # the encoder's layout: [B, S, H*64] viewed as [B, H, S, 64]
        b, h, s, _ = shape
        return torch.randn((b, s, h, 64), generator=gen, device=dev).to(dtype).transpose(1, 2)

    def hold(name, what, got, want, heads=slice(None)):
        nonlocal checks
        dt = "bf16" if got.dtype == torch.bfloat16 else "f32"
        err = (got[:, heads].float() - want.float()).abs().max().item()
        atol = K5_BWD_ATOL_F32 if dt == "f32" else max(K5_BWD_REL_BF16 * want.float().abs().max().item(), 2e-3)
        if not (torch.isfinite(got.float()).all() and err <= atol):
            raise AssertionError(f"K5 {what} {dt} {tuple(got.shape)} layout {name!r}: max |diff| {err} > {atol}")
        key = f"K5 {'dq' if what == 'dq' else 'dkv'} {dt}"
        errs[key] = max(errs.get(key, 0.0), err)
        checks += 1

    def residuals_agree(name, l, m, pl, pm):
        real = pm != fa.MASK_VALUE
        if not (torch.equal(real, m != fa.MASK_VALUE)
                and torch.allclose(m[real], pm[real], rtol=1e-5, atol=1e-5)
                and torch.allclose(l, pl, rtol=2e-5, atol=0)):
            raise AssertionError(f"K5 forward residuals differ from the plain version's, layout {name!r}: "
                                 f"|dl| {(l - pl).abs().max().item()}, |dm| {(m[real] - pm[real]).abs().max().item()}")

    def compare(name, q, k, v, seg_q, seg_kv):
        do = strided(q.shape, q.dtype)
        out, l, m = fa._forward_cuda(q, k, v, seg_q, seg_kv, 0.125, True)
        _, pl, pm = fa.flash_attention_plain(q, k, v, seg_q, seg_kv, 0.125, save_residuals=True)
        residuals_agree(name, l, m, pl, pm)
        del pl, pm
        got = fa.flash_attention_backward(q, k, v, seg_q, seg_kv, out, l, m, do, 0.125)
        again = fa.flash_attention_backward(q, k, v, seg_q, seg_kv, out, l, m, do, 0.125)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"K5 backward {tuple(q.shape)} layout {name!r}: two runs differ")
        want = fa.flash_attention_backward_plain(q, k, v, seg_q, seg_kv, out, l, m, do, 0.125)
        for what, g, w in zip(("dq", "dk", "dv"), got, want):
            hold(name, what, g, w)
        di = (out.float() * do.float()).sum(dim=-1).contiguous()
        for what in ("dkv", "dq"):
            _counted_tiles_share(q, k, v, seg_q, seg_kv, l, m, do, di, what)
        return do, got

    for dt, b, h, s in K5_CHECKS:
        dtype = getattr(torch, dt)
        for name, seg_np in _segment_layouts(rng, b, s).items():
            q, k, v = (strided((b, h, s, 64), dtype) for _ in range(3))
            seg = torch.as_tensor(seg_np, device=dev)
            do, got = compare(name, q, k, v, seg, seg)
        # through torch.autograd: the Function's forward and backward give the same bits
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        auto = torch.autograd.grad(fa.flash_attention_segments(*leaves, seg, seg, 0.125), leaves, do)
        if not all(torch.equal(a, g) for a, g in zip(auto, got)):
            raise AssertionError(f"K5 backward {dt} {(b, h, s)}: torch.autograd through the Function differs")
        # rows whose segment id no key carries: every p = 1/l, and the gradient flows
        compare("rows no key matches", q, k, v, _no_key_rows(seg), seg)
        for name, (seg_q, seg_kv) in _skip_layouts(b, s).items():  # the tile skip's edges
            compare(name, q, k, v, torch.as_tensor(seg_q, device=dev), torch.as_tensor(seg_kv, device=dev))
        del q, k, v, do, got, auto, leaves
    for dt in ("float32", "bfloat16"):
        seg_np = _segment_layouts(rng, 4, 8192)
        for name in ("mask", "packed"):
            q, k, v, do = (strided((4, 16, 8192, 64), getattr(torch, dt)) for _ in range(4))
            seg = torch.as_tensor(seg_np[name], device=dev)
            out, l, m = fa._forward_cuda(q, k, v, seg, seg, 0.125, True)
            got = fa.flash_attention_backward(q, k, v, seg, seg, out, l, m, do, 0.125)
            torch.cuda.synchronize()
            for head in (0, 15):
                hs = slice(head, head + 1)
                want = fa.flash_attention_backward_plain(
                    q[:, hs], k[:, hs], v[:, hs], seg, seg, out[:, hs], l[:, hs], m[:, hs], do[:, hs], 0.125)
                for what, g, w in zip(("dq", "dk", "dv"), got, want):
                    hold(f"S 8192 {name} head {head}", what, g, w, hs)
                del want
            del q, k, v, do, out, l, m, got
            torch.cuda.empty_cache()
    x = torch.zeros((1, 2, 128, 64), device=dev, dtype=torch.bfloat16)
    stat = torch.zeros((1, 2, 128), device=dev)
    seg = torch.zeros((1, 128), dtype=torch.int32, device=dev)
    for bad_do, why in ((x.float(), "do of another type"), (x[:, :1], "do of another shape")):
        try:  # what the kernels cannot take raises; nothing falls back to the plain version
            fa.flash_attention_backward(x, x, x, seg, seg, x, stat, stat, bad_do, 0.125)
        except ValueError:
            continue
        raise AssertionError(f"K5 backward accepted {why}")
    # k and v expanded over the heads (a zero stride): the forward reads them, so the backward takes them too
    q, do = (strided((1, 4, 256, 64), torch.bfloat16) for _ in range(2))
    kv = strided((1, 1, 256, 64), torch.bfloat16).expand(1, 4, 256, 64)
    seg = torch.ones((1, 256), dtype=torch.int32, device=dev)
    out, l, m = fa._forward_cuda(q, kv, kv, seg, seg, 0.125, True)
    got = fa.flash_attention_backward(q, kv, kv, seg, seg, out, l, m, do, 0.125)
    want = fa.flash_attention_backward(q, kv.contiguous(), kv.contiguous(), seg, seg, out, l, m, do, 0.125)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("K5 backward bf16: expanded k, v give other gradients than their copies")
    torch.cuda.empty_cache()
    log(f"phase 2 K5 backward: {checks} kernel-vs-plain checks passed, every run repeated bit-equal; "
        f"max |err| {json.dumps(errs)}")
    return errs


# ------------------------------------------------------------------ phase 3

ROOT = Path(__file__).resolve().parent
ENCODER_MID = ROOT / "intool_rag_tpu" / "models" / "weights" / "encoder_mid.npz"
N_SERVICE_DOCS, CHUNKS_PER_DOC, N_REQUESTS = 200, 250, 16
SERVICE_STORES = [  # (label, env, the only kernel variant that store may launch)
    ("K1 bf16 store", {"DENSE_INT8": "0", "DENSE_INT8_RESIDUAL": "0"}, "K1 bf16 precise"),
    ("K1 f32 store", {"INDEX_DTYPE": "float32", "DENSE_INT8": "0", "DENSE_INT8_RESIDUAL": "0"}, "K1 f32"),
    ("K1 f16 store", {"INDEX_DTYPE": "float16", "DENSE_INT8": "0", "DENSE_INT8_RESIDUAL": "0"}, "K1 f16"),
    ("K2 int8 mirror", {"DENSE_INT8": "1", "DENSE_INT8_RESIDUAL": "0"}, "K2 int8+q2"),
    ("K2 int8r mirror", {"DENSE_INT8": "1", "DENSE_INT8_RESIDUAL": "1"}, "K2 int8r"),
    # the 1-bit capacity tier with the default IVF_NLIST 1024 / IVF_NPROBE 64:
    # about 50 rows per list, one 1,024-slot block per list
    ("K3 bits tier", {"INDEX_KIND": "bits", "IVF_REFINE_K": "100", "DENSE_INT8": "0",
                      "DENSE_INT8_RESIDUAL": "0"}, "K3"),
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


def _write_storage(storage_dir: Path, texts: list[str], provider, n_docs: int = N_SERVICE_DOCS) -> None:
    from intool_rag_tpu_torch.ingest.schemas import (
        Chunk, ChunksIndex, NodeLevel, PageIndex, SemanticNode, VectorMeta, make_chunk_id,
    )
    from intool_rag_tpu_torch.storage.artifacts import FileStorageManager

    fsm = FileStorageManager(storage_dir)
    t0 = time.perf_counter()
    emb = provider.embed_batch(texts, is_query=False)
    log(f"embedded {len(texts)} chunks with encoder_mid in {time.perf_counter() - t0:.1f} s")
    for d in range(n_docs):
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


def _wrappers():
    from intool_rag_tpu_torch.ops.bits_scan import bits_scan
    from intool_rag_tpu_torch.ops.flash_attention import (
        flash_attention_dkv, flash_attention_dq, flash_attention_segments,
    )
    from intool_rag_tpu_torch.ops.flat_fused import partial_topk, partial_topk_int8
    from intool_rag_tpu_torch.ops.quant import quantize_int8_stochastic

    return (partial_topk, partial_topk_int8, bits_scan, quantize_int8_stochastic, flash_attention_segments,
            flash_attention_dkv, flash_attention_dq)


def _launches() -> dict[str, int]:
    out: dict[str, int] = {}
    for wrapper in _wrappers():
        out.update(wrapper.launches.by_variant)
    return out


def _reset_launches() -> None:
    for wrapper in _wrappers():
        wrapper.launches.reset()


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
    dense = service.registry.engine.dense
    if variant == "K3":  # the staged hybrid path over the tier, built once from the whole store
        tier = dense._ivf
        if dense.routes_flat() or tier is None or tier.total_rows != len(service.registry.store):
            raise AssertionError(f"{label}: /search did not go through the capacity tier")
        log(f"phase 3 {label}: nlist {tier.nlist}, {tier.blocks_per_list} block(s) per list, "
            f"{tier.bytes_resident / 1e6:.1f} MB on the card, {tier.bytes_host / 1e6:.1f} MB on the host")
    elif not dense.routes_flat():
        raise AssertionError(f"{label}: a flat store routed to the capacity tier")
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
        base = {"STORAGE_DIR": tmp, "CACHE_DIR": os.path.join(tmp, "cache"), "INDEX_DTYPE": "bfloat16",
                "USE_PALLAS": "1",
                "EMBEDDING_QUERY_INSTRUCTION": "", "INDEX_KIND": "flat", "IVF_REFINE_K": "0"}
        runs = [
            _serve_and_query(label, {**base, **env}, variant, provider, questions, expected)
            for label, env, variant in SERVICE_STORES
        ]
    state["default_config_ingest"] = _ingest_default_config(provider, texts[:60])
    state["service"] = runs
    launches: dict[str, int] = {}
    for run in runs:
        for name, count in run["launches"].items():
            launches[name] = launches.get(name, 0) + count
    state["launches"] = launches


def _ingest_default_config(provider, texts: list[str]) -> dict:
    """The port's native analyzer is built and serves ``tokenize``; then a
    service on a fresh store with ``LLM_PROVIDER`` unset and no Gemini key
    (and no Ollama on this machine) answers ``POST /ingest`` through the
    heuristic analyzer, and ``/search`` finds the document."""
    from intool_rag_tpu_torch import config, native
    from intool_rag_tpu_torch.index.analyzer import tokenize
    from intool_rag_tpu_torch.llm.semantic import factory
    from intool_rag_tpu_torch.service.app import RAGService
    from intool_rag_tpu_torch.service.http import ServiceServer

    if not native.native_available():
        raise AssertionError("the port's native analyzer did not build (g++ missing or failed)")
    terms = tokenize("€uro price 5€")
    log(f"phase 3: native analyzer {native.library_path().name} serves tokenize: '€uro price 5€' -> {terms}")
    if terms != ["€uro", "price", "5€"]:
        raise AssertionError(f"tokenize went around the native analyzer: {terms}")
    for name in ("LLM_PROVIDER", "GEMINI_API_KEY"):
        os.environ.pop(name, None)
    pages = ["\n\n".join(texts[i : i + 6]) for i in range(0, len(texts), 6)]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_default_") as tmp:
        os.environ.update({"STORAGE_DIR": tmp, "CACHE_DIR": os.path.join(tmp, "cache"), "INDEX_KIND": "flat",
                           "INDEX_DTYPE": "bfloat16", "DENSE_INT8": "0",
                           "DENSE_INT8_RESIDUAL": "0", "IVF_REFINE_K": "0"})
        config.reset_config()
        factory.reset_semantic_analyzer()
        server = ServiceServer(RAGService(provider, device=DEVICE), host="127.0.0.1", port=0)
        server.start_background()
        try:
            t0 = time.perf_counter()
            out = _upload(server.port, "default", "doc-default", "default.txt", "\f".join(pages).encode())
            ingest_s = time.perf_counter() - t0
            analyzer = type(factory.get_semantic_analyzer()).__name__
            _, hits = _post(server.port, texts[7])
        finally:
            server.shutdown()
    if analyzer != "HeuristicSemanticAnalyzer":
        raise AssertionError(f"the default configuration chose {analyzer}, not the heuristic analyzer")
    if out["total_chunks"] < 1 or not hits["hits"] or hits["hits"][0]["doc_id"] != "doc-default":
        raise AssertionError(f"default-config ingest: {out}, /search {hits['hits'][:1]}")
    result = {"analyzer": analyzer, "pages": out["total_pages"], "chunks": out["total_chunks"],
              "ingest_s": ingest_s, "native_library": native.library_path().name}
    log(f"phase 3 default configuration (LLM_PROVIDER unset, no key, no Ollama): {json.dumps(result)}")
    return result


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
    operations / peak), inputs read once, outputs written once. ``n`` is
    the corpus rows the function needs, those below valid_n: a padded row
    scores -inf whatever it holds."""
    nbytes = n_q_ops * q * d * elem + n_c_ops * n * d * elem + (4 * n if scales else 0) + q * cand_cols * 8
    ops = passes * 2.0 * q * n * d
    t_bytes, t_ops = nbytes / H100_HBM_BYTES_S, ops / peak
    return 1000 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_scale(state: dict) -> None:
    from intool_rag_tpu_torch.index.bm25_index import bm25_dispatch
    from intool_rag_tpu_torch.index.hybrid import _fuse
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

    corpus32 = torch.randn((n_pad, DIM), generator=gen, device=dev)
    corpus32 /= corpus32.norm(dim=1, keepdim=True)  # the f32 store: a true f32 corpus, 4.1 GB
    corpus = corpus32.bfloat16()
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
    batch = {"q": q_emb, "qtf": qtf, "bm25": bm25_arrays, "statics": statics,
             "rotations": [(qterms + 31 * i) % VOCAB for i in range(4)], "paths": {
                 "K2 int8r": ((c1, cs, c2), dict(kind="fused_int8")),
                 "K1 bf16 precise": ((corpus,), dict(kind="fused", precise=True)),
                 "K1 f32": ((corpus32,), dict(kind="fused", precise=False)),  # INDEX_DTYPE=float32
             }}
    paths = list(batch["paths"])

    # exact hybrid oracle on ORACLE_Q queries, per stored corpus (the bf16
    # one and its int8 mirror, the f32 one): exact f32-accumulated dense
    # top-k + exact f32 rescore, exact BM25, the same fusion
    qo, qto = q_emb[:ORACLE_Q], qterms[:ORACLE_Q]
    s_vals, s_rows = bm25_topk_sorted(qto, qtf[:ORACLE_Q], ts, tl, pd, pw, idf, CANDIDATES,
                                      n_docs=n, p_max=P_MAX)
    oracles = {}
    for label, stored in (("bf16", corpus), ("f32", corpus32)):
        d_vals, d_rows = flat_topk(qo, stored, CANDIDATES, metric="cosine", block_n=100_000, valid_n=n)
        d_vals = rescore_candidates(qo, stored, d_rows, metric="cosine")
        _, oracle = _fuse(d_vals, d_rows, s_vals, s_rows, TOP_K, fusion_mode="weighted", rrf_k=60,
                          w_dense=0.7, w_sparse=0.3)
        oracles[label] = oracle.cpu().numpy()

    results = {}
    state["launches_scale"] = {}
    for name in paths:
        oracle = oracles["f32" if name == "K1 f32" else "bf16"]
        _reset_launches()
        _, fast = _hybrid(batch, name, qterms)
        fast = fast[:ORACLE_Q].cpu().numpy()
        recall = sum(len(set(a) & set(b)) for a, b in zip(fast, oracle)) / oracle.size
        if recall < 0.99:
            raise AssertionError(f"{name}: recall@10 {recall} < 0.99 vs the exact hybrid oracle")
        qps = [1000 * Q_SCALE / _batch_ms(batch, name) for _ in range(3)]
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
        "K1 f32": lambda: ff.partial_topk(q_emb, None, corpus32, 32, n),
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
    state["kernels"] = _kernel_table(state, q_emb, corpus, corpus32, c1, c2, cs, n)
    # main() measures the batch's busy share after the last phase; where
    # phases follow this one, the batch waits for it in host memory
    state["scale_batch"] = batch if state["phases"][-1] == 4 else _moved(batch, "cpu")


def _hybrid(batch: dict, name: str, qterms: torch.Tensor):
    """Phase 4's hybrid search of the batch's queries on the path ``name``."""
    from intool_rag_tpu_torch.index.hybrid import _fused_hybrid_search

    arrays, kind = batch["paths"][name]
    return _fused_hybrid_search(batch["q"], arrays, qterms, batch["qtf"], batch["bm25"], 0.7, 0.3,
                                **batch["statics"], **kind)


def _batch_ms(batch: dict, name: str) -> float:
    """Host wall time (ms) of one hybrid batch, the mean over the rotations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for qt in batch["rotations"]:
        _hybrid(batch, name, qt)
    torch.cuda.synchronize()
    return 1000 * (time.perf_counter() - t0) / len(batch["rotations"])


def scale_busy_share(state: dict) -> None:
    """The device's busy share of phase 4's hybrid batch: kernel time under
    torch.profiler over the rotations, against the batch time of unprofiled
    passes over the same rotations just before. main() runs it after the
    last phase, since a process that has traced runs its host side slower
    (``qps_after_profiler`` shows by how much) and phases 5-7 time host work."""
    batch = _moved(state.pop("scale_batch"), DEVICE)
    results = state["scale"]
    n_rot = len(batch["rotations"])
    for name in batch["paths"]:
        warm_until = time.perf_counter() + 1.0  # untimed: the first batches after phases 5-7 ran slower
        while time.perf_counter() < warm_until:
            _batch_ms(batch, name)
        runs = [_batch_ms(batch, name) for _ in range(3)]
        batch_ms = float(np.mean(runs))
        kernels = _profiled_kernels(lambda: [_hybrid(batch, name, qt) for qt in batch["rotations"]])
        busy_ms = sum(ms for _, ms, _ in kernels) / n_rot
        entry = results[name]
        entry.update(batch_ms=batch_ms, batch_ms_runs=runs)
        if busy_ms > 0:
            if busy_ms > batch_ms:
                log(f"WARNING phase 4 {name}: device busy {busy_ms} ms exceeds the batch's {batch_ms} ms; "
                    f"the profiler's kernel times and the host clock disagree")
            top = sorted(kernels, key=lambda k: -k[1])[:6]
            entry.update({
                "device_busy_ms_per_batch": busy_ms, "device_busy_share": busy_ms / batch_ms,
                "kernel_launches_per_batch": sum(c for _, _, c in kernels) / n_rot,
                "top_kernels_ms_per_batch": {k[:40]: ms / n_rot for k, ms, _ in top}})
        else:
            entry["device_busy_share"] = "not measured: torch.profiler reported no device time"
        entry["qps_after_profiler"] = 1000 * Q_SCALE / _batch_ms(batch, name)
    keep = ("batch_ms", "batch_ms_runs", "device_busy_ms_per_batch", "device_busy_share",
            "kernel_launches_per_batch", "top_kernels_ms_per_batch", "qps_after_profiler")
    log(f"phase 4 device busy share of a hybrid batch: "
        f"{json.dumps({k: {f: v.get(f) for f in keep} for k, v in results.items()})}")


def _moved(obj, device):
    """``obj`` with every tensor in it (through dicts and tuples) on ``device``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, (tuple, list)):
        return type(obj)(_moved(x, device) for x in obj)
    if isinstance(obj, dict):
        return {k: _moved(v, device) for k, v in obj.items()}
    return obj


SERVICE_SHAPE = (16, 53_248, 50_000, 384, 32)  # (Q, N, valid_n, D, group_l): the phase-3 store at batch 16


def _k12_timing(name, args, g, valid_n, wall=False) -> dict:
    """One K1/K2 variant on these operands: kernel, bound and the library's
    product-only time (``torch.mm`` / ``torch._int_mm`` per product over the
    rows below valid_n), all device times; with ``wall``, also the host side
    and wall time per call of both, and the host side of the C entry alone."""
    extra = {}
    if name.startswith("K1"):
        a_hi, a_lo, c = args
        products = [(a, c[:valid_n].T) for a in (a_hi, a_lo) if a is not None]
        if c.dtype == torch.float32:  # three tf32 products on the tensor cores; the f32-FMA bound beside
            bound = _bound(a_hi.shape[0], valid_n, c.shape[1], 3, 4, 1, 1, H100_PEAK["tf32"], c.shape[0] // g)
            extra["fma_bound_ms"] = _bound(a_hi.shape[0], valid_n, c.shape[1], 1, 4, 1, 1, H100_PEAK["f32"],
                                           c.shape[0] // g)[0]
        else:  # bf16 and f16 share one peak
            bound = _bound(a_hi.shape[0], valid_n, c.shape[1], len(products), c.element_size(), len(products), 1,
                           H100_PEAK["bf16"], c.shape[0] // g)
        library = lambda: [torch.mm(a, b) for a, b in products]
    else:
        a1, a2, b1, b2, _ = args
        v1 = b1[:valid_n].T
        products = [(a1, v1)] + ([(a2, v1)] if a2 is not None else []) + (
            [(a1, b2[:valid_n].T)] if b2 is not None else [])
        bound = _bound(a1.shape[0], valid_n, b1.shape[1], len(products), 1, 1 + (a2 is not None),
                       1 + (b2 is not None), H100_PEAK["int8"], b1.shape[0] // g, scales=True)
        # torch._int_mm takes more than 16 rows on the left: a small batch goes on the right
        library = lambda: [torch._int_mm(a, b) if a.shape[0] > 16 else torch._int_mm(b.T, a.T)
                           for a, b in products]
    kernel = lambda: _kernel(name, args, g, valid_n)
    ms = cuda_ms(kernel)
    out = {"ms": ms, "bound_ms": bound[0], "bound_by": bound[1], "bound_share": bound[0] / ms, **extra,
           "library_ms": cuda_ms(library, iters=5, warmup=1)}
    if wall:
        (host, wall_), (lib_host, lib_wall) = host_wall_ms(kernel), host_wall_ms(library)
        out.update(wall_ms=wall_, host_ms=host, c_entry_host_ms=host_wall_ms(_c_entry(name, args, g, valid_n))[0],
                   library_wall_ms=lib_wall, library_host_ms=lib_host)
    return out


def _c_entry(name, args, g, valid_n):
    """K1/K2's C entry alone (tensor maps, launch, the ctypes call) on these
    operands, its outputs and merge scratch allocated once: the part of a
    call's host side that caching the tensor maps could shorten."""
    from intool_rag_tpu_torch.ops import flat_fused as ff

    q1, q2, c1, c2, scale = (*args[:2], args[2], None, None) if name.startswith("K1") else args
    if name == "K1 f32":  # the wrapper splits the queries before the C entry
        q1, q2 = ff.split_query_tf32(q1)
    (q, d), n, dev = q1.shape, c1.shape[0], c1.device
    n_sm = ff._sm_count(dev)
    width, splits = ff.plan_launch(q, n, d, g, n_sm, name)
    vals = torch.empty((q, n // g), device=dev)
    idx = torch.empty((q, n // g), dtype=torch.int32, device=dev)
    part_vals = torch.empty((splits, q, n // g), device=dev)
    part_j = torch.empty((splits, q, n // g), dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    arrivals = ff._arrivals(dev, stream, -(-q // width) * (n // (ff.LANES * g)))
    ptrs = [ff._ptr(t) for t in (c1, c2, q1, q2, scale)]
    out = [ff._ptr(t) for t in (vals, idx, part_vals, part_j, arrivals)]
    lib = ff._lib()
    args = (ff._KINDS[name][0], *ptrs, q, n, d, g, valid_n, width, splits, n_sm, *out, stream)
    ff._check_rc(lib.flat_partial_topk(*args), f"{name} C entry")
    return lambda: lib.flat_partial_topk(*args)


def _kernel_table(state, q_emb, corpus, c32, c1, c2, cs, n) -> list[dict]:
    """Every kernel variant at the phase-4 shape: the kernel checked against
    its plain version on the same inputs, both timed, the product-only
    library time, the bound, and the launches of the main-path runs; K1 f32
    on the true f32 corpus ``c32``, the others on the bf16 one and its
    mirrors. Every variant also at the phase-3 service shape."""
    from intool_rag_tpu_torch.ops.quant import quantize_int8_residual

    g = 32
    ch = corpus.half()
    errs = state.get("max_abs_err", {})
    src = "intool_rag_tpu_torch/kernels/flat_partial_topk.cu"
    replaces = {"K1": "intool_rag_tpu/ops/flat_pallas.py:96", "K2": "intool_rag_tpu/ops/flat_pallas.py:136"}
    gen = torch.Generator(device=corpus.device).manual_seed(5)
    sq, sn, s_valid, sd, sg = SERVICE_SHAPE
    s_corpus = _unit(gen, (sn, sd), corpus.device)
    s_c1, s_c2, s_cs = quantize_int8_residual(s_corpus)
    service = _operands(_unit(gen, (sq, sd), corpus.device), s_corpus.bfloat16(), s_corpus.half(), s_corpus,
                        s_c1, s_c2, s_cs)
    rows = []
    for name, args in _operands(q_emb, corpus, ch, c32, c1, c2, cs).items():
        kernel = lambda name=name, args=args: _kernel(name, args, g, n)
        plain = lambda name=name, args=args: _plain(name, args, g, n)
        err = _compare(name, args, kernel(), plain())
        torch.cuda.empty_cache()
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces[name[:2]],
            # main path: the phase-3 service runs; null for a variant no store runs
            "launches": state.get("launches", {}).get(name),
            "launches_scale": state.get("launches_scale", {}).get(name),
            "max_abs_err": max(err, errs.get(name, 0.0)),
            **_k12_timing(name, args, g, n), "plain_ms": cuda_ms(plain, iters=2, warmup=1),
        }
        if name in ("K1 f32", "K1 bf16 precise"):  # the operation-bound variants, held for a second
            entry["sustained_1s"] = clocks_under_load(kernel, entry["ms"])
        at = _k12_timing(name, service[name], sg, s_valid, wall=True)
        entry["service_shape"] = f"Q {sq}, N {sn:,}, valid_n {s_valid:,}, D {sd}, group_l {sg}"
        entry.update({f"service_{key}": value for key, value in at.items()})
        torch.cuda.empty_cache()
        rows.append(entry)
        log(f"kernel {json.dumps(entry)}")
    return rows


# ------------------------------------------------------------------ phase 5

CAP_ROWS, CAP_CHUNK, CAP_NLIST, CAP_BLOCK_N = 3_000_000, 250_000, 256, 1024
CAP_POOL, CAP_GROUP, CAP_KMEANS_ITERS, CAP_NPROBES = 100, 8, 8, (8, 16, 32)
MICRO_GROUP, MICRO_RADIUS = 10, 0.35


def micro_chunk(seed: int, centers: torch.Tensor, rows: int) -> torch.Tensor:
    """One chunk of the micro-cluster corpus, regenerated from its seed:
    every ``MICRO_GROUP`` consecutive rows share a micro-centre (a topic
    centre plus a radius-spread offset of norm ~``MICRO_RADIUS``) and
    scatter around it at ~10 % of that offset, so a query perturbed from a
    row has its group as true neighbours at a margin a quantizer can
    resolve. Unit-norm f32 rows on the centres' device."""
    dev, d = centers.device, centers.shape[1]
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_micro = rows // MICRO_GROUP

    def log_uniform(shape, lo, hi):
        u = torch.rand(shape, generator=gen, device=dev)
        return torch.exp(math.log(lo) + (math.log(hi) - math.log(lo)) * u)

    ids = torch.randint(0, centers.shape[0], (n_micro,), generator=gen, device=dev)
    u = torch.randn((n_micro, d), generator=gen, device=dev) / math.sqrt(d)
    r_micro = MICRO_RADIUS * log_uniform((n_micro, 1), 0.5, 1.5)
    micro = centers[ids] + r_micro * u
    s_row = 0.1 * r_micro[:, None, :] * log_uniform((n_micro, MICRO_GROUP, 1), 0.5, 2.0)
    w = torch.randn((n_micro, MICRO_GROUP, d), generator=gen, device=dev) / math.sqrt(d)
    out = (micro[:, None, :] + s_row * w).reshape(n_micro * MICRO_GROUP, d)
    return out / out.norm(dim=1, keepdim=True)


def _capacity_queries(centers: torch.Tensor) -> tuple[list[torch.Tensor], torch.Tensor, np.ndarray]:
    """The capacity runs' queries and oracle: 4 sets of ``Q_SCALE``
    perturbed copies of the first rows of chunk 3 (the last set for
    warm-up), and the exact-f32 top-``TOP_K`` of the first ``ORACLE_Q``
    queries of set 0, streamed over the chunks regenerated from their
    seeds. Returns ``(sets, oracle queries, oracle rows)``."""
    dev, d = centers.device, centers.shape[1]
    q_src = micro_chunk(1 + 3, centers, CAP_CHUNK)[:Q_SCALE]
    noise = 0.1 * 0.35 / math.sqrt(d)
    qs = []
    for i in range(4):
        qgen = torch.Generator(device=dev).manual_seed(100 + i)
        qn = q_src + noise * torch.randn((Q_SCALE, d), generator=qgen, device=dev)
        qs.append(qn / qn.norm(dim=1, keepdim=True))
    q_sub = qs[0][:ORACLE_Q]
    best_v = torch.full((ORACLE_Q, TOP_K), float("-inf"), device=dev)
    best_i = torch.full((ORACLE_Q, TOP_K), -1, dtype=torch.long, device=dev)
    for c in range(CAP_ROWS // CAP_CHUNK):
        v, p = torch.topk(q_sub @ micro_chunk(1 + c, centers, CAP_CHUNK).T, TOP_K, dim=1)
        mv, mi = torch.cat([best_v, v], dim=1), torch.cat([best_i, p + c * CAP_CHUNK], dim=1)
        best_v, pos = torch.topk(mv, TOP_K, dim=1)
        best_i = torch.gather(mi, 1, pos)
    return qs, q_sub, best_i.cpu().numpy()


def _recall(got: np.ndarray, oracle: np.ndarray) -> float:
    return sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(got, oracle)) / oracle.size


def _scan_bound(probe_blocks, bpl, block_n, d, q, n_cand) -> tuple[float, str, dict]:
    """Least time (ms) for this scan: max(bytes / HBM rate, operations /
    bf16 peak). Bytes: every DISTINCT probed block once (codes + scales),
    queries, probe table and centroid dots once, candidates written once.
    Operations: 2 x 8 queries x D for every slot a tile scans."""
    from intool_rag_tpu_torch.ops.bits_scan import scan_plan_reference

    blocks = probe_blocks.long()[:, :, None] + torch.arange(bpl, device=probe_blocks.device)
    distinct = int(torch.unique(blocks).numel())
    scanned = int(blocks.numel())
    planned = len(scan_plan_reference(probe_blocks)[0]) * bpl  # blocks the kernel reads: one per item
    block_bytes = block_n * (d // 8 + 32)
    nbytes = distinct * block_bytes + q * d * 2 + probe_blocks.numel() * 4 * 2 + q * n_cand * 8
    ops = 2.0 * 8 * d * scanned * block_n
    t_bytes, t_ops = nbytes / H100_HBM_BYTES_S, ops / H100_PEAK["bf16"]
    detail = {"distinct_block_mb": distinct * block_bytes / 1e6,
              "scanned_block_mb": scanned * block_bytes / 1e6,
              "planned_block_mb": planned * block_bytes / 1e6, "candidate_mb": q * n_cand * 8 / 1e6}
    return 1000 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), detail


K3_SERVICE_SHAPE = (384, 1024, 1, 1024, 64, 16, 8)  # the phase-3 bits store at batch 16 (as in K3_CHECKS)


def _k3_service_shape(gen, dev) -> dict:
    """K3 at the service shape: device ms by events, bound, the library's
    product-only time (``torch.bmm`` on the probed blocks decoded to bf16),
    and the host side and wall time per call of the wrapper."""
    from intool_rag_tpu_torch.ops.bits_scan import bits_scan, decode_bits_planar

    d, block_n, bpl, nlist, nprobe, q, group_l = K3_SERVICE_SHAPE
    args, kw = _k3_inputs(gen, *K3_SERVICE_SHAPE, dev)
    kernel = lambda: bits_scan(*args, **kw)
    _compare_k3(args, kw, kernel(), _k3_plain(args, kw))
    n_cand = nprobe * bpl * block_n // group_l
    bound = _scan_bound(args[3], bpl, block_n, d, q, n_cand)
    codes3 = args[1].reshape(-1, block_n, d // 8)
    decoded = torch.stack([
        decode_bits_planar(codes3[args[3][t].long()].reshape(-1, d // 8),
                           args[2][args[3][t].long()].permute(0, 2, 1).reshape(-1, 8).abs()).bfloat16()
        for t in range(q // 8)])
    q_tiles = args[0].reshape(q // 8, 8, d)
    ms = cuda_ms(kernel, iters=50, warmup=5)
    host, wall = host_wall_ms(kernel)
    return {"service_shape": f"Q {q}, D {d}, block_n {block_n}, nlist {nlist}, nprobe {nprobe}, group_l {group_l}",
            "service_ms": ms, "service_bound_ms": bound[0], "service_bound_by": bound[1],
            "service_bound_share": bound[0] / ms, "service_distinct_block_mb": bound[2]["distinct_block_mb"],
            "service_library_ms": cuda_ms(lambda: torch.bmm(q_tiles, decoded.transpose(1, 2)), iters=20, warmup=2),
            "service_host_ms": host, "service_wall_ms": wall}


def phase_capacity(state: dict) -> None:
    from intool_rag_tpu_torch.index.bits_index import IVFBitsIndex, tile_probes
    from intool_rag_tpu_torch.ops.bits_scan import bits_scan, decode_bits_planar
    from intool_rag_tpu_torch.ops.flat_fused import _candidates_topk
    from intool_rag_tpu_torch.ops.quant import (
        quantize_int8_stochastic, quantize_int8_stochastic_reference,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    dev = torch.device(DEVICE)
    d, n_chunks = DIM, CAP_ROWS // CAP_CHUNK
    gen = torch.Generator(device=dev).manual_seed(0)
    centers = _unit(gen, (CAP_NLIST, d), dev)

    t0 = time.perf_counter()
    index = IVFBitsIndex.train(
        micro_chunk(1, centers, CAP_CHUNK), CAP_NLIST, capacity=int(1.06 * CAP_ROWS),
        block_n=CAP_BLOCK_N, iters=CAP_KMEANS_ITERS, refine=True, device=dev,
    )
    torch.cuda.synchronize()
    kmeans_s = time.perf_counter() - t0
    if index.blocks_per_list != 13:
        raise AssertionError(f"phase 5: {index.blocks_per_list} blocks per list, expected 13")
    t0 = time.perf_counter()
    for c in range(n_chunks):
        index.append(micro_chunk(1 + c, centers, CAP_CHUNK))
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    once = {
        "rows": index.total_rows, "kmeans_s": kmeans_s, "ingest_rows_per_s": CAP_ROWS / ingest_s,
        "card_mb": index.bytes_resident / 1e6, "host_mb": index.bytes_host / 1e6,
        "lists": index.nlist, "blocks_per_list": index.blocks_per_list,
        "fill_max": int(index.fill.max()), "cap_l": index.cap_l,
    }
    log(f"phase 5 ingest: {json.dumps(once)}")

    qs, q_sub, oracle = _capacity_queries(centers)

    def search(qv, k, nprobe, refine_k):
        return index.search(qv, k, nprobe=nprobe, refine_k=refine_k, group_l=CAP_GROUP)

    # ---- the main path: counts set to 0 just before, read just after
    _reset_launches()
    results: dict[int, dict] = {}
    for nprobe in CAP_NPROBES:
        search(qs[3], TOP_K, nprobe, CAP_POOL)  # warm-up: host tier consolidation, allocations
        times = []
        for qv in qs[:3]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            search(qv, TOP_K, nprobe, CAP_POOL)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        vals, rows = search(q_sub, TOP_K, nprobe, CAP_POOL)
        _, pool = search(q_sub, CAP_POOL, nprobe, None)
        if not (torch.isfinite(vals).all() and tuple(rows.shape) == (ORACLE_Q, TOP_K)):
            raise AssertionError(f"phase 5 nprobe {nprobe}: malformed result")
        results[nprobe] = {
            "qps_mean": Q_SCALE / float(np.mean(times)), "qps_runs": [Q_SCALE / t for t in times],
            "ms_per_batch": 1000 * float(np.mean(times)),
            "recall@10": _recall(rows.cpu().numpy(), oracle),
            "pool@100": _recall(pool.cpu().numpy(), oracle),
        }
    launches = _launches()
    if set(launches) != {"K3"}:
        raise AssertionError(f"phase 5: the dense side launched {launches}, expected only K3")
    state.setdefault("launches_scale", {})["K3"] = launches["K3"]

    # ---- per-stage times on each nprobe's own inputs (not counted as the main path)
    bpl, block_n = index.blocks_per_list, index.block_n
    scan_kw = dict(blocks_per_list=bpl, block_n=block_n, group_l=CAP_GROUP)
    table_args = None
    for nprobe in CAP_NPROBES:
        qf = qs[0]
        order, q_sorted, probes, c_sel = tile_probes(qf, index.centroids, nprobe)
        args = (q_sorted.bfloat16().contiguous(), index.codes, index.scales,
                (probes * bpl).to(torch.int32).contiguous(), c_sel.contiguous())
        cand = bits_scan(*args, **scan_kw)
        _, pool_rows = search(qf, CAP_POOL, nprobe, None)
        refine = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            index._refine(qf, pool_rows, TOP_K)
            torch.cuda.synchronize()
            refine.append(1000 * (time.perf_counter() - t0))
        bound = _scan_bound(args[3], bpl, block_n, d, Q_SCALE, cand[0].shape[1])
        results[nprobe].update({
            "probes_ms": cuda_ms(lambda: tile_probes(qf, index.centroids, nprobe)),
            "k3_ms": cuda_ms(lambda: bits_scan(*args, **scan_kw)),
            "k3_bound_ms": bound[0], **bound[2],
            "tail_ms": cuda_ms(lambda: _candidates_topk(*cand, CAP_POOL, tail="fold")),
            "refine_ms": float(np.mean(refine)),
        })
        if nprobe == 16:
            table_args = args
        del cand
    state["capacity"] = {"once": once, "by_nprobe": results}
    log(f"phase 5 (3M x d1024, Q 256, k 10 of pool 100, group_l 8): {json.dumps(results)}")
    r16 = results[16]
    if r16["recall@10"] < 0.95 or r16["pool@100"] < 0.95:
        raise AssertionError(
            f"phase 5: nprobe 16 recall@10 {r16['recall@10']} / pool@100 {r16['pool@100']} < 0.95")

    # ---- kernel table rows: K3 on the nprobe-16 inputs, K4 on one append chunk
    errs = state.get("max_abs_err", {})
    kernel = lambda: bits_scan(*table_args, **scan_kw)
    plain = lambda: _k3_plain(table_args, scan_kw)
    err = _compare_k3(table_args, scan_kw, kernel(), plain())
    n_cand = 16 * bpl * block_n // CAP_GROUP
    bound = _scan_bound(table_args[3], bpl, block_n, d, Q_SCALE, n_cand)
    k3_row = {
        "name": "K3", "route": "cuda", "source": "intool_rag_tpu_torch/kernels/bits_scan.cu",
        "replaces": "intool_rag_tpu/ops/bits_pallas.py:79",
        "launches": state.get("launches", {}).get("K3"), "launches_scale": launches["K3"],
        "max_abs_err": max(err, errs.get("K3", 0.0)),
        "ms": cuda_ms(kernel), "plain_ms": cuda_ms(plain, iters=2, warmup=1),
        "bound_ms": bound[0], "bound_by": bound[1], **bound[2],
    }
    k3_row["bound_share"] = bound[0] / k3_row["ms"]
    # product-only library time: the probed blocks decoded to bf16 once, then
    # one torch.bmm over the 32 tiles
    codes3 = index.codes.reshape(-1, block_n, d // 8)
    tiles = []
    for t in range(Q_SCALE // 8):
        blk = (table_args[3][t].long()[:, None] + torch.arange(bpl, device=dev)).reshape(-1)
        per_slot = index.scales[blk].permute(0, 2, 1).reshape(-1, 8).abs()
        tiles.append(decode_bits_planar(codes3[blk].reshape(-1, d // 8), per_slot).bfloat16())
    decoded = torch.stack(tiles)  # [32, slots per tile, D]
    del tiles
    q_tiles = table_args[0].reshape(Q_SCALE // 8, 8, d)
    k3_row["library_ms"] = cuda_ms(lambda: torch.bmm(q_tiles, decoded.transpose(1, 2)), iters=5, warmup=1)
    del decoded
    torch.cuda.empty_cache()
    k3_row.update(_k3_service_shape(gen, dev))
    log(f"kernel {json.dumps(k3_row)}")

    x = micro_chunk(1, centers, CAP_CHUNK)
    k4_row = {
        "name": "K4", "route": "cuda", "source": "intool_rag_tpu_torch/kernels/quant_stochastic.cu",
        "replaces": "intool_rag_tpu/ops/quant.py:66",
        # read from the wrapper's counter like every other row: null where no
        # service ran. No served path calls the stochastic quantizer (nor does
        # one in the JAX package), so a run's counters hold no K4 entry
        "launches": state["launches"].get("K4", 0) if "launches" in state else None,
        "launches_scale": launches.get("K4", 0),
        "max_abs_err": errs["K4"] if "K4" in errs else _check_k4(dev),
        "ms": cuda_ms(lambda: quantize_int8_stochastic(x, seed=1)),
        "plain_ms": cuda_ms(lambda: quantize_int8_stochastic_reference(x, seed=1), iters=3, warmup=1),
        "bound_ms": 1000 * (x.numel() * 5 + x.shape[0] * 4) / H100_HBM_BYTES_S, "bound_by": "bytes",
        "library_ms": None,
    }
    log(f"kernel {json.dumps(k4_row)}")
    state.setdefault("kernels", []).extend([k3_row, k4_row])


# ------------------------------------------------------------------ phase 6

INGEST_SEED = 6
PACKED_DOCS, PACKED_PAGES = 8, 12          # text files; plus one PDF of PDF_PAGES pages
PDF_PAGES = 10
PACK_WIDTH = 2048
# pages (= chunks) of the long-context documents, in tokens: one document per
# sequence bucket and one that mixes them
LONG_DOCS = {
    "long-1024": (620, 700, 840, 980), "long-2048": (1200, 1500, 1900),
    "long-4096": (2300, 3000, 3900), "long-8192": (4500, 6500, 7000),
    "long-mixed": (650, 1700, 3300, 5200),
}
LONG_BUCKETS = {1024, 2048, 4096, 8192}
# layers, hidden, heads, flash_min_len, dtype, K5 variant: the bge_m3 configuration
INGEST_WIDTH = (24, 1024, 16, 1024, "bfloat16", "K5 bf16")


def _ingest_vocab(rng: np.random.Generator) -> list[str]:
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    return ["".join(rng.choice(letters, size=rng.integers(3, 10))) for _ in range(20_000)]


def _sentences(rng, vocab, n_words: int) -> str:
    """``n_words`` Zipf-distributed pseudo-words as sentences of 8-20 words."""
    picks = (rng.zipf(1.3, size=n_words) - 1) % len(vocab)
    out, pos = [], 0
    while pos < n_words:
        n = int(rng.integers(8, 21))
        out.append(" ".join(vocab[w] for w in picks[pos : pos + n]).capitalize() + ".")
        pos += n
    return " ".join(out)


def _paged_text(rng, vocab, pages: int, title: str) -> str:
    """A text document paginated by form feeds: a numbered heading and a few
    blank-line-separated paragraphs per page (about 3 default-size chunks)."""
    out = []
    for p in range(pages):
        paras = [_sentences(rng, vocab, int(rng.integers(40, 110))) for _ in range(int(rng.integers(3, 6)))]
        out.append(f"{p + 1}. {title} part {p + 1}\n\n" + "\n\n".join(paras))
    return "\f".join(out)


def _long_text(rng, vocab, page_tokens: tuple[int, ...]) -> str:
    """One paragraph of about ``n`` tokens per page (the tokenizer drops stopwords
    and one-letter words; the pseudo-words have three letters or more)."""
    return "\f".join(f"{i + 1}. Section {i + 1}\n\n" + _sentences(rng, vocab, n - 6)
                     for i, n in enumerate(page_tokens))


def _text_pdf(page_texts: list[str]) -> bytes:
    """A text PDF: Flate content streams and one font whose codes only its
    ToUnicode CMap maps to text (shown as hex strings), classic xref table."""
    import zlib

    def flate(data: bytes) -> bytes:
        z = zlib.compress(data)
        return b"<< /Length %d /Filter /FlateDecode >>\nstream\n" % len(z) + z + b"\nendstream"

    chars = sorted({c for t in page_texts for c in t if c != "\n"})
    code = {c: 0x21 + i for i, c in enumerate(chars)}
    bfchar = "\n".join(f"<{code[c]:02X}> <{ord(c):04X}>" for c in chars)
    cmap = (
        "/CIDInit /ProcSet findresource begin 12 dict begin begincmap\n"
        "/CMapName /Adobe-Identity-UCS def /CMapType 2 def\n"
        "1 begincodespacerange <00> <FF> endcodespacerange\n"
        f"{len(chars)} beginbfchar\n{bfchar}\nendbfchar\n"
        "endcmap CMapName currentdict /CMap defineresource pop end end\n"
    ).encode()
    n = len(page_texts)
    pages_id, catalog = 3 + 2 * n, 4 + 2 * n
    bodies = {1: b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica /ToUnicode 2 0 R >>", 2: flate(cmap)}
    for i, text in enumerate(page_texts):
        ops = [b"BT /F1 10 Tf 72 760 Td 12 TL"]
        for j, line in enumerate(text.split("\n")):
            ops.append((b"T* " if j else b"") + b"<" + "".join(f"{code[c]:02X}" for c in line).encode() + b"> Tj")
        ops.append(b"ET")
        bodies[3 + i] = flate(b"\n".join(ops))
        bodies[3 + n + i] = (b"<< /Type /Page /Parent %d 0 R /MediaBox [0 0 612 792] /Resources << /Font "
                             b"<< /F1 1 0 R >> >> /Contents %d 0 R >>" % (pages_id, 3 + i))
    kids = b" ".join(b"%d 0 R" % (3 + n + i) for i in range(n))
    bodies[pages_id] = b"<< /Type /Pages /Kids [%s] /Count %d >>" % (kids, n)
    bodies[catalog] = b"<< /Type /Catalog /Pages %d 0 R >>" % pages_id
    out, offsets = bytearray(b"%PDF-1.4\n"), {}
    for num in sorted(bodies):
        offsets[num] = len(out)
        out += b"%d 0 obj\n" % num + bodies[num] + b"\nendobj\n"
    xref = len(out)
    out += b"xref\n0 %d\n0000000000 65535 f \n" % (catalog + 1)
    for num in range(1, catalog + 1):
        out += b"%010d 00000 n \n" % offsets[num]
    out += b"trailer\n<< /Size %d /Root %d 0 R >>\nstartxref\n%d\n%%%%EOF" % (catalog + 1, catalog, xref)
    return bytes(out)


def _ingest_documents() -> tuple[list, list]:
    """Phase 6's uploads, ``(project, doc_id, file name, bytes, mode)``:
    eight paginated text files and one text PDF (the packed run), and the
    long-context text files."""
    rng = np.random.default_rng(INGEST_SEED)
    vocab = _ingest_vocab(rng)
    packed_uploads = [
        (f"project{d % 2}", f"text{d:02d}", f"text{d:02d}.txt",
         _paged_text(rng, vocab, PACKED_PAGES, f"Report {d}").encode(), "async" if d == 2 else "sync")
        for d in range(PACKED_DOCS)
    ]
    pdf_pages = [f"{p + 1}. Invoice part {p + 1}\n" + "\n".join(
        _sentences(rng, vocab, int(rng.integers(60, 120))) for _ in range(4)) for p in range(PDF_PAGES)]
    packed_uploads.append(("project0", "pdf00", "invoice.pdf", _text_pdf(pdf_pages), "sync"))
    long_uploads = [(f"project{i % 2}", name, f"{name}.txt", _long_text(rng, vocab, pages).encode(),
                     "async" if i == 1 else "sync") for i, (name, pages) in enumerate(LONG_DOCS.items())]
    return packed_uploads, long_uploads


def _http(port: int, method: str, path: str, body: bytes | None = None, ctype: str | None = None) -> dict:
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, method=method,
                                 headers={"Content-Type": ctype} if ctype else {})
    with urllib.request.urlopen(req, timeout=600) as resp:  # a status of 400 and above raises
        return json.loads(resp.read())


def _upload(port: int, project: str, doc_id: str, name: str, data: bytes, mode: str = "sync") -> dict:
    boundary = "----chipsmoke6"
    body = (f'--{boundary}\r\nContent-Disposition: form-data; name="file"; filename="{name}"\r\n'
            "Content-Type: application/octet-stream\r\n\r\n").encode() + data + f"\r\n--{boundary}--\r\n".encode()
    path = f"/ingest?project={project}&doc_id={doc_id}" + ("&mode=async" if mode == "async" else "")
    out = _http(port, "POST", path, body, f"multipart/form-data; boundary={boundary}")
    if mode != "async":
        if not out["success"]:
            raise AssertionError(f"/ingest of {name} failed: {out}")
        return out
    deadline = time.time() + 600
    while time.time() < deadline:
        job = _http(port, "GET", f"/jobs/{out['job_id']}")
        if job["status"] in ("done", "failed"):
            break
        time.sleep(0.05)
    if job["status"] != "done":
        raise AssertionError(f"async ingest of {name} ended as {job}")
    return job["result"]


def _k5_bound(seg: torch.Tensor, heads: int, elem: int) -> dict:
    """Least time (ms) for K5 on these segment ids: the operations are
    4 x 64 per (query, key) pair of equal id and per head, over the bf16
    tensor-core rate (f32: three tf32 products each, 3xTF32, over the tf32
    rate, with the CUDA-core f32 bound beside as ``fma_bound_ms``); the
    bytes q, k, v and the output once plus both id arrays. ``dense_ms``
    counts every pair."""
    b, s = seg.shape
    pairs = sum(int((torch.bincount(row) ** 2).sum()) for row in seg.long())
    passes, peak = (1, H100_PEAK["bf16"]) if elem == 2 else (3, H100_PEAK["tf32"])
    t_bytes = (4 * b * heads * s * 64 * elem + 2 * 4 * b * s) / H100_HBM_BYTES_S
    t_ops = passes * 4.0 * heads * 64 * pairs / peak
    out = {"bound_ms": 1000 * max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "dense_bound_ms": 1000 * max(t_bytes, passes * 4.0 * heads * 64 * b * s * s / peak)}
    if elem == 4:
        out["fma_bound_ms"] = 1000 * max(t_bytes, 4.0 * heads * 64 * pairs / H100_PEAK["f32"])
    return out


def _k5_inputs(seg: torch.Tensor, heads: int, dtype, gen):
    b, s = seg.shape
    return [torch.randn((b, s, heads, 64), generator=gen, device=seg.device).to(dtype).transpose(1, 2)
            for _ in range(3)]


def _cosine_rows(a: np.ndarray, b: np.ndarray) -> float:
    return float(((a * b).sum(axis=1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))).min())


def _ingest_run(label: str, env: dict, encoder, uploads: list, forwards: list) -> dict:
    """One service on a fresh STORAGE_DIR: ingest ``uploads`` through
    ``POST /ingest``, check the counters, then serve ``/search``,
    ``GET /documents/{id}`` and ``DELETE /documents/{id}``."""
    from intool_rag_tpu_torch import config
    from intool_rag_tpu_torch.index.bm25_index import BM25Index
    from intool_rag_tpu_torch.ops.flash_attention import flash_attention_plain
    from intool_rag_tpu_torch.providers.cuda_embed import CudaEmbeddingProvider
    from intool_rag_tpu_torch.service.app import RAGService
    from intool_rag_tpu_torch.service.http import ServiceServer

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ingest_") as tmp:
        os.environ.update({"STORAGE_DIR": tmp, "CACHE_DIR": os.path.join(tmp, "cache"), "INDEX_DTYPE": "bfloat16",
                           "INDEX_KIND": "flat",
                           "IVF_REFINE_K": "0", "DENSE_INT8": "0", "DENSE_INT8_RESIDUAL": "0",
                           "USE_PALLAS": "1", "LLM_PROVIDER": "heuristic",
                           # the encoder's weights are random, so its CLS vectors lie within rounding
                           # of each other and the dense rank is noise: BM25 carries the quoted
                           # chunk, and gets the larger weight so that a chunk outside the dense
                           # candidates still wins the fusion
                           "BM25_WEIGHT": "0.7", "VECTOR_WEIGHT": "0.3", **env})
        config.reset_config()
        provider = CudaEmbeddingProvider(encoder, model_name="bge_m3-width-random")  # reads EMBED_PACKED
        service = RAGService(provider, device=DEVICE)
        server = ServiceServer(service, host="127.0.0.1", port=0)
        server.start_background()
        try:
            # ---- the main path: counts set to 0 just before, read just after
            _reset_launches()
            flash_attention_plain.calls.reset()
            forwards.clear()
            torch.cuda.reset_peak_memory_stats()
            timings = {"host": 0.0, "embed": 0.0, "persist": 0.0, "append": 0.0}
            t0 = time.perf_counter()
            chunks = 0
            for project, doc_id, name, data, mode in uploads:
                out = _upload(server.port, project, doc_id, name, data, mode)
                chunks += out["total_chunks"] if mode == "sync" else out["chunk_count"]
                for key in timings:  # one worker: the document just ingested is the last one
                    timings[key] += service.last_ingest_timings[key]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            ingest_forwards = list(forwards)
            launches = _launches()
            plain_calls = flash_attention_plain.calls.count
            peak_mb = torch.cuda.max_memory_allocated() / 1e6

            long_forwards = [f for f in ingest_forwards if f[1] >= 1024]
            if not long_forwards or launches.get(INGEST_WIDTH[5], 0) != INGEST_WIDTH[0] * len(long_forwards):
                raise AssertionError(
                    f"{label}: K5 launched {launches.get(INGEST_WIDTH[5], 0)} times for {len(long_forwards)} "
                    f"encoder forwards at S >= 1024 (expected {INGEST_WIDTH[0]} each)")
            if plain_calls or set(launches) != {INGEST_WIDTH[5]}:
                raise AssertionError(f"{label}: ingest called the plain version {plain_calls} times, "
                                     f"launched {launches}")
            logits_mb = 16 * 8192 * 8192 * 4 / 1e6  # one row's [16, S, S] f32 at S 8192
            if peak_mb > 0.75 * logits_mb:
                raise AssertionError(f"{label}: peak device memory {peak_mb:.0f} MB is not far below "
                                     f"the {logits_mb:.0f} MB of one row's f32 logits at S 8192")

            store = service.registry.store
            tokens = int(sum(provider.tokenizer.encode_batch(store.texts[i : i + 64])[1].sum()
                             for i in range(0, len(store), 64)))
            row_tokens = sum(b * s for b, s in ingest_forwards)
            if len(store) != chunks:
                raise AssertionError(f"{label}: {chunks} chunks ingested, {len(store)} in the live corpus")
            fresh_vocab = len(BM25Index.build(store.texts, device=DEVICE).vocab)
            if service.registry.stats()["bm25_vocab"] != fresh_vocab:
                raise AssertionError(f"{label}: appended BM25 vocabulary != a fresh build's {fresh_vocab}")

            # ---- it serves: a quote of one chunk per document comes back in the top 5
            _reset_launches()
            rng = np.random.default_rng(INGEST_SEED)
            doc_ids = [u[1] for u in uploads]
            quotes = {}
            for doc_id in doc_ids:
                rows = store.rows_for_doc(doc_id)
                row = rows[int(rng.integers(len(rows)))]
                quotes[doc_id] = (store.chunk_ids[row], store.texts[row])

            def check_found(doc_id):
                hits = _http(server.port, "POST", "/search", json.dumps({"question": quotes[doc_id][1]}).encode(),
                             "application/json")["hits"]
                top = [(h["doc_id"], h["chunk_id"]) for h in hits[:5]]
                if (doc_id, quotes[doc_id][0]) not in top:
                    raise AssertionError(f"{label}: quoted chunk {(doc_id, quotes[doc_id][0])} not in top 5 {top}")
                return hits

            for doc_id in doc_ids:
                check_found(doc_id)
            detail = _http(server.port, "GET", f"/documents/{doc_ids[0]}")
            if not detail["nodes"] or detail["chunk_count"] < 1:
                raise AssertionError(f"{label}: GET /documents/{doc_ids[0]} shows no tree: {detail}")
            victim = doc_ids[1]
            if _http(server.port, "DELETE", f"/documents/{victim}") != {"deleted": victim}:
                raise AssertionError(f"{label}: DELETE /documents/{victim} failed")
            hits = _http(server.port, "POST", "/search", json.dumps({"question": quotes[victim][1]}).encode(),
                         "application/json")["hits"]
            if any(h["doc_id"] == victim for h in hits):
                raise AssertionError(f"{label}: deleted document {victim} still comes back from /search")
            for doc_id in doc_ids:
                if doc_id != victim:
                    check_found(doc_id)
            search_launches = _launches()
            if "K1 bf16 precise" not in search_launches:
                raise AssertionError(f"{label}: /search after ingest launched {search_launches}, not K1")
            texts_by_doc = {d: [store.texts[r] for r in store.rows_for_doc(d)] for d in doc_ids}
        finally:
            server.shutdown()
            service.tasks.shutdown()
    out = {
        "run": label, "documents": len(uploads), "chunks": chunks, "tokens": tokens,
        "encoder_forwards": len(ingest_forwards), "forwards_at_s_ge_1024": len(long_forwards),
        "forward_shapes": sorted({f for f in ingest_forwards}),
        "real_token_share": tokens / row_tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
        "host_s": timings["host"], "embed_s": timings["embed"],
        "persist_append_s": timings["persist"] + timings["append"],
        "k5_launches": launches[INGEST_WIDTH[5]], "plain_calls": plain_calls, "peak_mb": peak_mb,
        "search_launches": search_launches,
    }
    log(f"phase 6 {label}: {json.dumps(out)}")
    out["texts_by_doc"] = texts_by_doc
    return out


def phase_ingest(state: dict) -> None:
    import dataclasses

    from intool_rag_tpu_torch.models.encoder import EncoderConfig, TextEncoder
    from intool_rag_tpu_torch.ops.flash_attention import flash_attention_plain
    from intool_rag_tpu_torch.providers.cuda_embed import CudaEmbeddingProvider

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(INGEST_SEED)
    cfg = EncoderConfig.bge_m3()
    if (cfg.num_layers, cfg.hidden_size, cfg.num_heads, cfg.flash_min_len, cfg.dtype) != INGEST_WIDTH[:5]:
        raise AssertionError(f"phase 6 expects the bge_m3 width, got {cfg}")
    encoder = TextEncoder(cfg, device=dev).init_random(gen).eval()
    forwards: list[tuple[int, int]] = []
    encoder.register_forward_pre_hook(lambda _m, args: forwards.append(tuple(args[0].shape)))
    packed_uploads, long_uploads = _ingest_documents()

    packed = _ingest_run("packed ingest", {"EMBED_PACKED": "1", "EMBED_PACK_WIDTH": str(PACK_WIDTH)},
                         encoder, packed_uploads, forwards)
    if not 200 <= packed["chunks"] <= 1000 or not all(1024 <= s <= PACK_WIDTH for _, s in packed["forward_shapes"]):
        raise AssertionError(f"phase 6 packed ingest: {packed['chunks']} chunks in rows {packed['forward_shapes']}")
    long = _ingest_run("long-context ingest",
                       {"EMBED_PACKED": "0", "CHUNK_MAX_CHARS": "200000", "CHUNK_TARGET_CHARS": "200000"},
                       encoder, long_uploads, forwards)
    if {s for _, s in long["forward_shapes"]} != LONG_BUCKETS:
        raise AssertionError(f"phase 6 long-context ingest: buckets {long['forward_shapes']}")

    # ---- same answers both ways (not the main path): the K5 route against the
    # same weights with flash_min_len = 0 (pair-mask / key-mask route), and
    # packed against padded
    os.environ.update({"EMBED_PACKED": "1", "EMBED_PACK_WIDTH": str(PACK_WIDTH)})
    enc0 = TextEncoder(dataclasses.replace(cfg, flash_min_len=0), device=dev).eval()
    enc0.load_state_dict(encoder.state_dict())
    k5_packed, mask_packed = CudaEmbeddingProvider(encoder), CudaEmbeddingProvider(enc0)
    os.environ["EMBED_PACKED"] = "0"
    k5_padded, mask_padded = CudaEmbeddingProvider(encoder), CudaEmbeddingProvider(enc0)
    sample = [t for texts in packed["texts_by_doc"].values() for t in texts[:6]]
    long_sample = [t for d in ("long-1024", "long-2048") for t in long["texts_by_doc"][d]]
    flash_attention_plain.calls.reset()
    a = k5_packed.embed_batch(sample)
    cos = {
        "packed: K5 vs pair mask": _cosine_rows(a, mask_packed.embed_batch(sample)),
        "packed (K5) vs padded": _cosine_rows(a, k5_padded.embed_batch(sample)),
        "long (S <= 2048): K5 vs key mask": _cosine_rows(k5_padded.embed_batch(long_sample),
                                                         mask_padded.embed_batch(long_sample)),
    }
    log(f"phase 6 same answers both ways, min cosine over rows: {json.dumps(cos)}")
    if min(cos.values()) < 0.999 or flash_attention_plain.calls.count:
        raise AssertionError(f"phase 6: routes disagree (cosine {cos}) or the plain version ran")
    del enc0, mask_packed, mask_padded
    torch.cuda.empty_cache()

    for run in (packed, long):
        run.pop("texts_by_doc")
    state["ingest"] = {"packed": packed, "long": long, "cosine": cos}
    _k5_times_and_rows(state, encoder, gen)


def _k5_times_and_rows(state: dict, encoder, gen) -> None:
    """K5 per launch at each shape the ingest runs gave it, the encoder
    forward, and K5's rows of the kernel table (not the main path)."""
    from intool_rag_tpu_torch.ops.flash_attention import (
        flash_attention_plain, flash_attention_segments,
    )

    dev, cfg = torch.device(DEVICE), encoder.config
    packed, long = state["ingest"]["packed"], state["ingest"]["long"]
    k5_times = []
    shapes = sorted({f for f in packed["forward_shapes"] + long["forward_shapes"]})
    for b, s in shapes:
        if (b, s) in packed["forward_shapes"]:  # a packed row: ~100-token segments
            seg = (torch.arange(s, device=dev) // 100 + 1).to(torch.int32).repeat(b, 1)
        else:
            seg = (torch.arange(s, device=dev)[None] < int(0.8 * s)).to(torch.int32).repeat(b, 1)
        q, k, v = _k5_inputs(seg, 16, torch.bfloat16, gen)
        ms = cuda_ms(lambda: flash_attention_segments(q, k, v, seg, seg, 0.125), iters=5, warmup=1)
        k5_times.append({"B": b, "S": s, "ms": ms, **_k5_bound(seg, 16, 2),
                         "tiles_computed_share": _counted_fwd_tiles_share(q, k, v, seg, seg, "ingest")})
    log(f"phase 6 K5 per launch: {json.dumps(k5_times)}")
    fwd = {}
    for b, s in ((4, 2048), (1, 8192)):
        ids = torch.randint(4, cfg.vocab_size, (b, s), generator=gen, device=dev, dtype=torch.int32)
        mask = torch.ones_like(ids)
        with torch.no_grad():
            fwd[f"S{s}_B{b}_ms"] = cuda_ms(lambda: encoder(ids, mask), iters=3, warmup=1)
    log(f"phase 6 encoder forward (bge_m3 width, bf16): {json.dumps(fwd)}")

    # ---- kernel table rows: the long-context shape (one row of S 8192, the 0/1
    # mask of a 6,500-token chunk as segment ids), bf16 and f32
    seg = (torch.arange(8192, device=dev)[None] < 6500).to(torch.int32)
    pair = (seg[:, None, :, None] == seg[:, None, None, :])
    rows = []
    for dt, name in ((torch.bfloat16, "K5 bf16"), (torch.float32, "K5 f32")):
        q, k, v = (x.contiguous() for x in _k5_inputs(seg, 16, dt, gen))
        kernel = lambda: flash_attention_segments(q, k, v, seg, seg, 0.125)
        plain = lambda: flash_attention_plain(q, k, v, seg, seg, 0.125)
        library = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=pair, scale=0.125)
        got, want = kernel(), plain()
        err = (got.float() - want.float()).abs().max().item()
        rel = _row_rel_err(got, want)
        del want
        lib_err = (got.float() - library().float()).abs().max().item()  # reported, not a bar
        del got
        if err > K5_ATOL[str(dt).split(".")[-1]] or (dt == torch.bfloat16 and rel > K5_FWD_REL_BF16):
            raise AssertionError(f"{name} at S 8192: |kernel - plain| {err}, row-relative {rel}")
        torch.cuda.empty_cache()
        row = {
            "name": name, "route": "cuda", "source": "intool_rag_tpu_torch/kernels/flash_attention.cu",
            "replaces": "intool_rag_tpu/models/encoder.py:138",
            # main path: the two ingest runs of this phase; the f32 variant serves f32 encoders only
            # (phase 7's f32 gradient check fills its count)
            "launches": (packed["k5_launches"] + long["k5_launches"]) if dt == torch.bfloat16 else None,
            "max_abs_err": max(err, state.get("max_abs_err", {}).get(name, 0.0)),
            "ms": cuda_ms(kernel, iters=5, warmup=1), "plain_ms": cuda_ms(plain, iters=2, warmup=1),
            **_k5_bound(seg, 16, q.element_size()),
            "library_ms": cuda_ms(library, iters=5, warmup=1), "max_abs_diff_library": lib_err,
            "max_row_rel_err": max(rel, state.get("k5_row_rel_err", 0.0)) if dt == torch.bfloat16 else rel,
        }
        # the kernel's own count of the tiles it computed (bf16 and f32, each at its tiles)
        row["tiles_computed_share"] = _counted_fwd_tiles_share(q, k, v, seg, seg, "kernel table")
        row["bound_share"] = row["bound_ms"] / row["ms"]
        if dt == torch.bfloat16:  # the packed rows' width too
            seg2 = (torch.arange(2048, device=dev) // 100 + 1).to(torch.int32).repeat(4, 1)
            q2, k2, v2 = (x.contiguous() for x in _k5_inputs(seg2, 16, dt, gen))
            pair2 = (seg2[:, None, :, None] == seg2[:, None, None, :])
            row["s2048_b4"] = {
                "ms": cuda_ms(lambda: flash_attention_segments(q2, k2, v2, seg2, seg2, 0.125), iters=5, warmup=1),
                "library_ms": cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                    q2, k2, v2, attn_mask=pair2, scale=0.125), iters=5, warmup=1),
                **_k5_bound(seg2, 16, 2),
                "tiles_computed_share": _counted_fwd_tiles_share(q2, k2, v2, seg2, seg2, "packed rows"),
            }
        rows.append(row)
        log(f"kernel {json.dumps(row)}")
        del q, k, v
        torch.cuda.empty_cache()
    state["ingest"].update({"k5_per_launch": k5_times, "forward": fwd})
    state.setdefault("kernels", []).extend(rows)


# ------------------------------------------------------------------ phase 7

TRAIN_SEED = 7
TRAIN_LR = 2e-5
TRAIN_Q_LEN = 128                              # the queries' rows: key-mask route
# (steps, pairs, passage S): the passages take the K5 route. InfoNCE needs as many
# queries as passages, and two pairs at least for a loss that is not identically 0.
TRAIN_RUNS = ((6, 4, 2048), (2, 2, 8192))
# the short-row trainers at encoder_mid width: steps of the encoder, of the reranker, batch
SHORT_STEPS, RERANK_STEPS, SHORT_BATCH = 300, 800, 64
RERANK_PAIRS, RERANK_PACK_WIDTH = 100, 2048
# packed against bucketed reranker scores at bge_m3 width, bf16: the two layouts round
# 24 layers of bf16 activations at other places; the head's tanh keeps |score| below ~1
RERANK_PACKED_ATOL = 0.05


def _train_batch(gen, cfg, pairs: int, s_p: int, dev) -> dict:
    """A fixed synthetic batch of ``pairs`` queries and passages: random ids,
    every row padded after a tail of its own length (the first fills its row)."""

    def rows(n, s):
        ids = torch.randint(4, cfg.vocab_size, (n, s), generator=gen, device=dev, dtype=torch.int32)
        lengths = torch.linspace(s, 0.55 * s, n, device=dev).long()[:, None]
        mask = (torch.arange(s, device=dev)[None] < lengths).to(torch.int32)
        ids = torch.where(mask.bool(), ids, torch.full_like(ids, cfg.pad_token_id))
        ids[:, 0] = 0  # CLS
        return ids, mask

    q_ids, q_mask = rows(pairs, TRAIN_Q_LEN)
    p_ids, p_mask = rows(pairs, s_p)
    return {"q_ids": q_ids, "q_mask": q_mask, "p_ids": p_ids, "p_mask": p_mask}


def _k5_counts() -> dict[str, int]:
    from intool_rag_tpu_torch.ops import flash_attention as fa

    return {"launches": _launches(), "plain_forward": fa.flash_attention_plain.calls.count,
            "plain_backward": fa.flash_attention_backward_plain.calls.count}


def _reset_k5_counts() -> None:
    from intool_rag_tpu_torch.ops import flash_attention as fa

    _reset_launches()
    fa.flash_attention_plain.calls.reset()
    fa.flash_attention_backward_plain.calls.reset()


def _train_full_width(state: dict, dev, gen) -> None:
    """A few contrastive steps at the bge_m3 width through K5 forward, dkv
    and dq: the main path of this phase."""
    from intool_rag_tpu_torch.models.encoder import EncoderConfig, TextEncoder
    from intool_rag_tpu_torch.train.contrastive import TrainState, make_optimizer, make_train_step

    cfg = EncoderConfig.bge_m3()
    if (cfg.num_layers, cfg.hidden_size, cfg.num_heads, cfg.flash_min_len, cfg.dtype) != INGEST_WIDTH[:5]:
        raise AssertionError(f"phase 7 expects the bge_m3 width, got {cfg}")
    layers = cfg.num_layers
    model = TextEncoder(cfg, device=dev, param_dtype=torch.float32).init_random(gen).train()
    n_params = sum(p.numel() for p in model.parameters())
    train_state = TrainState(model, *make_optimizer(model, TRAIN_LR))
    step_fn = make_train_step(cfg)
    runs = []
    for steps, n_p, s_p in TRAIN_RUNS:
        batch = _train_batch(gen, cfg, n_p, s_p, dev)
        tokens = int(batch["q_mask"].sum() + batch["p_mask"].sum())
        row_tokens = n_p * (TRAIN_Q_LEN + s_p)
        torch.cuda.synchronize()
        resident_mb = torch.cuda.memory_allocated() / 1e6
        # ---- the main path: counts set to 0 just before, read just after
        _reset_k5_counts()
        torch.cuda.reset_peak_memory_stats()
        losses, step_ms = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            _, loss = step_fn(train_state, batch)
            torch.cuda.synchronize()
            step_ms.append(1000 * (time.perf_counter() - t0))
            losses.append(loss)
        counts = _k5_counts()
        peak_mb = torch.cuda.max_memory_allocated() / 1e6
        losses = [float(x) for x in torch.stack(losses).cpu()]
        want = {"K5 bf16": layers * steps, "K5 dkv bf16": layers * steps, "K5 dq bf16": layers * steps}
        if counts["launches"] != want or counts["plain_forward"] or counts["plain_backward"]:
            raise AssertionError(f"phase 7 training at S {s_p}: counts {counts}, expected launches {want} "
                                 "and no plain call")
        # the first run repeats its batch six times: its loss must fall; the long run's two
        # steps (one update between its two readings, on moments of the other batch) must be finite
        if not all(math.isfinite(x) for x in losses) or (steps >= 6 and not losses[-1] < losses[0]):
            raise AssertionError(f"phase 7 training at S {s_p}: losses {losses} are not finite and falling")
        logits_mb = layers * n_p * cfg.num_heads * s_p * s_p * 4 / 1e6  # what autograd would keep without K5
        warm = step_ms[1:]
        run = {
            "steps": steps, "queries": [n_p, TRAIN_Q_LEN], "passages": [n_p, s_p],
            "tokens": tokens, "row_tokens": row_tokens, "losses": losses, "step_ms": step_ms,
            "step_ms_after_first": float(np.median(warm)), "tokens_per_s": 1000 * tokens / float(np.median(warm)),
            "launches": counts["launches"], "plain_calls": 0, "resident_before_mb": resident_mb,
            "peak_mb": peak_mb, "s2_logits_24_layers_mb": logits_mb,
        }
        log(f"phase 7 training, bge_m3 width ({n_params / 1e6:.0f} M f32 masters, bf16 compute): {json.dumps(run)}")
        runs.append(run)
    long_run = runs[-1]
    if long_run["peak_mb"] > 0.25 * long_run["s2_logits_24_layers_mb"]:
        raise AssertionError(f"phase 7: peak {long_run['peak_mb']:.0f} MB is not far below the "
                             f"{long_run['s2_logits_24_layers_mb']:.0f} MB of 24 layers of f32 logits at S 8192")
    state["train"] = {"runs": runs, "parameters": n_params}
    _step_breakdown(state, model, train_state, _train_batch(gen, cfg, *TRAIN_RUNS[0][1:], dev))
    del model, train_state
    torch.cuda.empty_cache()


def _profiled_kernels(fn) -> list[tuple[str, float, int]]:
    """``(name, device ms, launches)`` of every kernel ``fn()`` runs, from
    ``torch.profiler``; empty when the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # kernels only: an operator's entry repeats the time of the kernels it launched
    return [(e.key, e.self_device_time_total / 1000, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False) and not e.key.startswith("Optimizer.")]


def _step_breakdown(state: dict, model, train_state, batch: dict) -> None:
    """Where a training step's time goes at the first run's shape (not the
    main path): forward, backward and optimizer by CUDA events, then one
    step under ``torch.profiler`` for the device's busy share and the
    kernels that take most of it."""
    from intool_rag_tpu_torch.train.contrastive import info_nce_loss

    def forward():
        return info_nce_loss(model(batch["q_ids"], batch["q_mask"]), model(batch["p_ids"], batch["p_mask"]), 0.05)

    def events(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end), out

    rounds = []
    for _ in range(3):
        fwd_ms, loss = events(forward)
        bwd_ms, _ = events(loss.backward)
        opt_ms, _ = events(train_state.optimizer.step)
        train_state.optimizer.zero_grad(set_to_none=True)
        rounds.append((fwd_ms, bwd_ms, opt_ms))
    fwd_ms, bwd_ms, opt_ms = (float(np.median(x)) for x in zip(*rounds))
    out = {"forward_ms": fwd_ms, "backward_ms": bwd_ms, "optimizer_ms": opt_ms}

    def step():
        forward().backward()
        train_state.optimizer.step()
        train_state.optimizer.zero_grad(set_to_none=True)

    kernels = _profiled_kernels(step)
    busy_ms = sum(ms for _, ms, _ in kernels)
    if busy_ms > 0:  # the profiler traced the card
        # the profiler slows the host, not the kernels: the idle share is taken against the
        # main path's own step time
        step_ms = state["train"]["runs"][0]["step_ms_after_first"]
        top = sorted(kernels, key=lambda k: -k[1])[:10]
        out["profiled_step"] = {
            "device_busy_ms": busy_ms, "kernel_launches": sum(calls for _, _, calls in kernels),
            "step_ms": step_ms, "device_idle_share": max(0.0, 1.0 - busy_ms / step_ms),
            "top_kernels": [{"name": name[:48], "ms": ms, "calls": calls} for name, ms, calls in top],
        }
    else:
        out["profiled_step"] = "not measured: torch.profiler reported no device time"
    state["train"]["step_breakdown"] = out
    state["train"]["optimizer_ms"] = opt_ms
    log(f"phase 7 step breakdown at {TRAIN_RUNS[0][1]} x S {TRAIN_RUNS[0][2]} (fused AdamW): {json.dumps(out)}")


def _gradient_routes_agree(state: dict, dev, gen) -> None:
    """Gradients on a 2-layer copy of the model: the K5 route (forward, dkv
    and dq kernels) against the same weights with ``flash_min_len=0`` (pair
    logits through torch autograd), cosine per parameter tensor.

    With random weights every CLS vector lies within rounding of the others
    and the InfoNCE loss sits at chance, so its gradient is a difference of
    nearly equal embeddings: in bf16 it is made of the forward's rounding
    noise on either route. So the bf16 kernels are held on a loss that reads
    every valid position of the passages' last hidden state through a fixed
    random projection, the step's own InfoNCE loss is held in f32, and its
    bf16 cosine is printed beside them. The key biases are left out
    everywhere: their true gradient is zero (a softmax does not see a
    constant added to every logit of a row), what is computed is noise."""
    import dataclasses

    from intool_rag_tpu_torch.models.encoder import EncoderConfig, TextEncoder
    from intool_rag_tpu_torch.train.contrastive import info_nce_loss

    def info_nce(model, batch, _proj):
        return info_nce_loss(model(batch["q_ids"], batch["q_mask"]), model(batch["p_ids"], batch["p_mask"]), 0.05)

    def projection(model, batch, proj):
        hidden = model(batch["p_ids"], batch["p_mask"], pool=False)
        return (hidden * proj).sum() / batch["p_mask"].sum()

    out = {}
    for label, dtype, loss_fn, bar in (("bf16 projection of the hidden state", "bfloat16", projection, 0.999),
                                       ("f32 InfoNCE", "float32", info_nce, 0.999),
                                       ("bf16 InfoNCE at chance", "bfloat16", info_nce, None)):
        cfg = dataclasses.replace(EncoderConfig.bge_m3(), num_layers=2, dtype=dtype)
        flash = TextEncoder(cfg, device=dev, param_dtype=torch.float32).init_random(gen).train()
        masked = TextEncoder(dataclasses.replace(cfg, flash_min_len=0), device=dev, param_dtype=torch.float32).train()
        masked.load_state_dict(flash.state_dict())
        batch = _train_batch(gen, cfg, *TRAIN_RUNS[0][1:], dev)
        proj = torch.randn(batch["p_ids"].shape + (cfg.hidden_size,), generator=gen, device=dev)
        proj = proj * batch["p_mask"][:, :, None]  # pad positions differ between the routes by design
        _reset_k5_counts()
        grads = []
        for model in (flash, masked):
            loss_fn(model, batch, proj).backward()
            grads.append({n: p.grad for n, p in model.named_parameters()})
        counts = _k5_counts()
        tag = "bf16" if dtype == "bfloat16" else "f32"
        want = {f"K5 {tag}": 2, f"K5 dkv {tag}": 2, f"K5 dq {tag}": 2}
        if counts["launches"] != want or counts["plain_forward"] or counts["plain_backward"]:
            raise AssertionError(f"phase 7 gradient check ({label}): counts {counts}, expected {want}, no plain call")
        cos = {}
        for name, g in grads[0].items():
            if name.endswith("key.bias") or grads[1][name] is None:
                continue
            a, b = g.double().flatten(), grads[1][name].double().flatten()
            cos[name] = float((a @ b) / (a.norm() * b.norm()))
        worst = min(cos, key=cos.get)
        out[label] = {"min_cosine": cos[worst], "at": worst, "tensors": len(cos), "bar": bar,
                      "launches": counts["launches"]}
        log(f"phase 7 gradients, K5 route vs pair-mask route (2 layers, S {TRAIN_RUNS[0][2]}), {label}: "
            f"min cosine {cos[worst]:.6f} at {worst} over {len(cos)} tensors")
        if bar is not None and not cos[worst] >= bar:
            raise AssertionError(f"phase 7: gradient cosine {cos[worst]} < {bar} at {worst} ({label})")
        del flash, masked, grads, proj
        torch.cuda.empty_cache()
    state["train"]["gradient_cosine"] = out


class _HashProvider:
    """Deterministic lexical hash embeddings: what hybrid retrieval sees of
    the synthetic relevance task before a trained model reorders it."""

    def __init__(self, dim: int = 256) -> None:
        self.dim = dim

    def embed_batch(self, texts, is_query=False):
        import hashlib

        out = np.zeros((len(texts), self.dim), np.float32)
        for i, t in enumerate(texts):
            for w in t.split():
                out[i, int.from_bytes(hashlib.md5(w.encode()).digest()[:4], "little") % self.dim] += 1.0
        return out / np.maximum(np.linalg.norm(out, axis=1, keepdims=True), 1e-9)


def _train_short_rows(state: dict, dev) -> None:
    """The short-row trainers at encoder_mid width (6 x 384, f32) on the
    synthetic relevance task: the trained encoder must beat the untrained
    one on dense NDCG@10, the trained reranker must beat hybrid retrieval."""
    import dataclasses

    from intool_rag_tpu_torch import config
    from intool_rag_tpu_torch.eval.harness import build_engine_from_texts, evaluate_engine
    from intool_rag_tpu_torch.eval.synthetic import make_relevance_task
    from intool_rag_tpu_torch.models.encoder import TextEncoder, load_encoder_checkpoint
    from intool_rag_tpu_torch.models.reranker import Reranker
    from intool_rag_tpu_torch.models.tokenizer import SimpleTokenizer
    from intool_rag_tpu_torch.providers.cuda_embed import CudaEmbeddingProvider
    from intool_rag_tpu_torch.train.contrastive import tokenize_pairs, train_encoder_cached
    from intool_rag_tpu_torch.train.rerank import build_pair_pool, train_reranker

    os.environ.update({"EMBEDDING_QUERY_INSTRUCTION": "", "EMBED_PACKED": "0", "RERANK_PACKED": "0",
                       "INDEX_KIND": "flat", "DENSE_INT8": "0", "DENSE_INT8_RESIDUAL": "0",
                       "BM25_WEIGHT": "0.3", "VECTOR_WEIGHT": "0.7"})
    config.reset_config()
    cfg = load_encoder_checkpoint(ENCODER_MID)[0]
    rng = np.random.default_rng(TRAIN_SEED)
    task = make_relevance_task(rng)
    tok = SimpleTokenizer(vocab_size=cfg.vocab_size, max_length=48)
    positive = task.train_labels > 0
    pairs = tokenize_pairs(tok, [q for q, keep in zip(task.train_queries, positive) if keep],
                           [p for p, keep in zip(task.train_passages, positive) if keep], max_len=32)

    def dense_ndcg(encoder) -> float:
        provider = CudaEmbeddingProvider(encoder, tokenizer=tok)
        engine = build_engine_from_texts(task.texts, provider, device=dev)
        return evaluate_engine(engine, provider, task.examples, k=10, modes=("dense",))["dense"]["ndcg@k"]

    untrained = TextEncoder(cfg, device=dev).init_flax(torch.Generator(device=dev).manual_seed(0))
    t0 = time.perf_counter()
    encoder, means = train_encoder_cached(cfg, pairs, steps=SHORT_STEPS, batch=SHORT_BATCH, lr=1e-3,
                                          steps_per_launch=50, device=dev)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    enc = {"steps": SHORT_STEPS, "batch": SHORT_BATCH, "pairs": int(positive.sum()), "mean_losses": means.tolist(),
           "ms_per_step": 1000 * enc_s / SHORT_STEPS, "ndcg_untrained": dense_ndcg(untrained),
           "ndcg_trained": dense_ndcg(encoder)}
    log(f"phase 7 train_encoder_cached at encoder_mid width: {json.dumps(enc)}")
    if not (means[-1] < means[0] and enc["ndcg_trained"] > enc["ndcg_untrained"]):
        raise AssertionError(f"phase 7: the contrastive trainer did not improve the encoder: {enc}")

    pool = build_pair_pool(tok, task.train_queries, task.train_passages, task.train_labels, max_len=32,
                           augment_shuffle=1, rng=rng)
    t0 = time.perf_counter()
    params, means = train_reranker(cfg, pool, steps=RERANK_STEPS, batch=SHORT_BATCH, lr=3e-4,
                                   steps_per_launch=50, device=dev)
    torch.cuda.synchronize()
    rer_s = time.perf_counter() - t0
    reranker = Reranker.create(cfg, tokenizer=tok, params=params, device=dev)
    hash_provider = _HashProvider()
    engine = build_engine_from_texts(task.texts, hash_provider, device=dev)
    quality = evaluate_engine(engine, hash_provider, task.examples, k=10, modes=("hybrid", "rerank"),
                              reranker=reranker, rerank_candidates=30)
    rer = {"steps": RERANK_STEPS, "batch": SHORT_BATCH, "pairs": len(pool.labels), "mean_losses": means.tolist(),
           "ms_per_step": 1000 * rer_s / RERANK_STEPS, **quality}
    log(f"phase 7 train_reranker at encoder_mid width: {json.dumps(rer)}")
    if not (means[-1] < means[0] and quality["rerank"]["ndcg@k"] > quality["hybrid"]["ndcg@k"]):
        raise AssertionError(f"phase 7: the trained reranker does not beat hybrid retrieval: {rer}")
    state["train"].update({"encoder_short": enc, "reranker_short": rer})


def _rerank_full_width(state: dict, dev, gen) -> None:
    """``Reranker.score_pairs`` of 100 pairs at bge_m3 width (random weights
    from a seed, bf16-resident body): packed rows of 2,048 tokens through K5
    against the bucketed scores."""
    from intool_rag_tpu_torch.models.encoder import EncoderConfig
    from intool_rag_tpu_torch.models.reranker import CrossEncoder, Reranker
    from intool_rag_tpu_torch.models.tokenizer import SimpleTokenizer

    cfg = EncoderConfig.bge_m3()
    os.environ.update({"RERANK_PACKED": "0", "RERANK_PACK_WIDTH": str(RERANK_PACK_WIDTH)})
    model = CrossEncoder(cfg, device=dev)
    model.body.init_random(gen)
    model.init_head(gen)
    reranker = Reranker(model, SimpleTokenizer(vocab_size=cfg.vocab_size, max_length=512))
    rng = np.random.default_rng(TRAIN_SEED)
    vocab = _ingest_vocab(rng)
    queries = [" ".join(rng.choice(vocab, size=int(rng.integers(4, 12)))) for _ in range(RERANK_PAIRS)]
    passages = [_sentences(rng, vocab, int(rng.integers(60, 260))) for _ in range(RERANK_PAIRS)]
    reranker.score_pairs(queries[:8], passages[:8])  # first-call allocations
    out = {}
    for label, packed in (("bucketed", False), ("packed", True)):
        _reset_k5_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores = reranker.score_pairs(queries, passages, packed=packed)
        torch.cuda.synchronize()
        out[label] = {"ms": 1000 * (time.perf_counter() - t0), "padding_waste": reranker.last_padding_waste,
                      **_k5_counts()}
        out[label + "_scores"] = scores
    diff = float(np.abs(out.pop("packed_scores") - out.pop("bucketed_scores")).max())
    out["max_abs_diff"] = diff
    log(f"phase 7 Reranker.score_pairs, {RERANK_PAIRS} pairs at bge_m3 width: {json.dumps(out)}")
    packed = out["packed"]
    k5 = packed["launches"].get("K5 bf16", 0)
    if (k5 == 0 or k5 % cfg.num_layers or set(packed["launches"]) != {"K5 bf16"} or packed["plain_forward"]
            or out["bucketed"]["launches"] or diff > RERANK_PACKED_ATOL):
        raise AssertionError(f"phase 7: packed reranker scoring went wrong: {out}")
    state["train"]["rerank_full_width"] = out
    del model, reranker
    torch.cuda.empty_cache()


def _k5_backward_bound(seg: torch.Tensor, heads: int, elem: int, what: str) -> dict:
    """Least time (ms) for one backward kernel on these ids. Operations per
    (query, key) pair of equal id and per head: dkv 8 x 64 (k.qT, v.doT,
    pT.do, dsT.q), dq 6 x 64 (q.kT, do.vT, ds.k); f32 runs each product as
    three tf32 products (3xTF32) at the tf32 peak, and its f32-FMA bound (one
    product at the f32 peak) stands beside as ``fma_bound_ms``. Bytes: q, k,
    v, do read, the gradients written (dkv two, dq one), l, m, di and both
    id arrays."""
    b, s = seg.shape
    pairs = sum(int((torch.bincount(row) ** 2).sum()) for row in seg.long())
    per_pair, outputs = (8.0, 2) if what == "dkv" else (6.0, 1)
    passes, peak = (1, H100_PEAK["bf16"]) if elem == 2 else (3, H100_PEAK["tf32"])
    t_bytes = ((4 + outputs) * b * heads * s * 64 * elem + 3 * 4 * b * heads * s + 2 * 4 * b * s) / H100_HBM_BYTES_S
    t_ops = passes * per_pair * heads * 64 * pairs / peak
    out = {"bound_ms": 1000 * max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "dense_bound_ms": 1000 * max(t_bytes, passes * per_pair * heads * 64 * b * s * s / peak)}
    if elem == 4:
        out["fma_bound_ms"] = 1000 * max(t_bytes, per_pair * heads * 64 * pairs / H100_PEAK["f32"])
    return out


def _k5_backward_times_and_rows(state: dict, dev, gen) -> None:
    """K5 forward, dkv and dq per launch at the two training shapes, and the
    backward kernels' rows of the kernel table (not the main path)."""
    from intool_rag_tpu_torch.ops import flash_attention as fa

    per_launch = []
    for b, s in ((4, 2048), (1, 8192)):
        seg = (torch.arange(s, device=dev)[None] < torch.linspace(s, 0.55 * s, b, device=dev).long()[:, None])
        seg = seg.to(torch.int32)
        q, k, v, do = _k5_inputs(seg, 16, torch.bfloat16, gen) + _k5_inputs(seg, 16, torch.bfloat16, gen)[:1]
        out, l, m = fa._forward_cuda(q, k, v, seg, seg, 0.125, True)
        di = (out.float() * do.float()).sum(dim=-1).contiguous()
        entry = {"B": b, "S": s,
                 "fwd_ms": cuda_ms(lambda: fa._forward_cuda(q, k, v, seg, seg, 0.125, True), iters=5, warmup=1),
                 "dkv_ms": cuda_ms(lambda: fa.flash_attention_dkv(q, k, v, seg, seg, l, m, do, di, 0.125), iters=5, warmup=1),
                 "dq_ms": cuda_ms(lambda: fa.flash_attention_dq(q, k, v, seg, seg, l, m, do, di, 0.125), iters=5, warmup=1),
                 "backward_ms": cuda_ms(lambda: fa.flash_attention_backward(q, k, v, seg, seg, out, l, m, do, 0.125), iters=5, warmup=1)}
        for what in ("fwd", "dkv", "dq"):
            bound = _k5_bound(seg, 16, 2) if what == "fwd" else _k5_backward_bound(seg, 16, 2, what)
            entry[f"{what}_bound_ms"], entry[f"{what}_dense_bound_ms"] = bound["bound_ms"], bound["dense_bound_ms"]
            entry[f"{what}_tiles_computed_share"] = (  # as the kernel counted them
                _counted_fwd_tiles_share(q, k, v, seg, seg, "training") if what == "fwd"
                else _counted_tiles_share(q, k, v, seg, seg, l, m, do, di, what))
        per_launch.append(entry)
    log(f"phase 7 K5 per launch (bf16, H 16): {json.dumps(per_launch)}")
    state["train"]["k5_per_launch"] = per_launch
    del q, k, v, do, out, l, m, di

    # ---- kernel table rows: one row of S 8192, the 0/1 mask of a 6,500-token chunk as ids
    seg = (torch.arange(8192, device=dev)[None] < 6500).to(torch.int32)
    pair = (seg[:, None, :, None] == seg[:, None, None, :])
    runs = state["train"]["runs"]
    errs = state.get("max_abs_err", {})
    rows = []
    for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        q, k, v = (x.contiguous() for x in _k5_inputs(seg, 16, dt, gen))
        do = _k5_inputs(seg, 16, dt, gen)[0].contiguous()
        out, l, m = fa._forward_cuda(q, k, v, seg, seg, 0.125, True)
        di = (out.float() * do.float()).sum(dim=-1).contiguous()
        got = fa.flash_attention_backward(q, k, v, seg, seg, out, l, m, do, 0.125)
        want = fa.flash_attention_backward_plain(q, k, v, seg, seg, out, l, m, do, 0.125)
        diffs = [(g.float() - w.float()).abs().max().item() for g, w in zip(got, want)]
        scale = max(w.float().abs().max().item() for w in want)
        atol = K5_BWD_ATOL_F32 if dt == torch.float32 else max(K5_BWD_REL_BF16 * scale, 2e-3)
        if max(diffs) > atol:
            raise AssertionError(f"K5 backward {tag} at S 8192: |kernel - plain| {diffs} > {atol}")
        del got, want
        torch.cuda.empty_cache()
        plain_ms = cuda_ms(lambda: fa.flash_attention_backward_plain(q, k, v, seg, seg, out, l, m, do, 0.125),
                           iters=2, warmup=1)
        torch.cuda.empty_cache()
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        lib_out = torch.nn.functional.scaled_dot_product_attention(*leaves, attn_mask=pair, scale=0.125)
        library_ms = cuda_ms(lambda: torch.autograd.grad(lib_out, leaves, do, retain_graph=True), iters=5, warmup=1)
        lib_grads = torch.autograd.grad(lib_out, leaves, do)
        mine = fa.flash_attention_backward(q, k, v, seg, seg, out, l, m, do, 0.125)
        lib_diff = max((a.float() - b.float()).abs().max().item() for a, b in zip(mine, lib_grads))  # reported, not a bar
        del lib_out, lib_grads, leaves, mine
        kernels = {
            "dkv": (lambda: fa.flash_attention_dkv(q, k, v, seg, seg, l, m, do, di, 0.125), max(diffs[1:])),
            "dq": (lambda: fa.flash_attention_dq(q, k, v, seg, seg, l, m, do, di, 0.125), diffs[0]),
        }
        for what, (kernel, err) in kernels.items():
            name = f"K5 {what} {tag}"
            row = {
                "name": name, "route": "cuda", "source": "intool_rag_tpu_torch/kernels/flash_attention_bwd.cu",
                "replaces": "intool_rag_tpu/models/encoder.py:138",
                # main path: this phase's training steps (bf16); the f32 variants serve f32 encoders,
                # which this phase runs in its f32 gradient check (2 layers)
                "launches": (sum(r["launches"][name] for r in runs) if dt == torch.bfloat16
                             else state["train"]["gradient_cosine"]["f32 InfoNCE"]["launches"][name]),
                "launches_per_step": INGEST_WIDTH[0] if dt == torch.bfloat16 else None,
                "max_abs_err": max(err, errs.get(name, 0.0)),
                "ms": cuda_ms(kernel, iters=5, warmup=1),
                # the plain version and the library call each return dq, dk and dv together
                "plain_ms": plain_ms, **_k5_backward_bound(seg, 16, q.element_size(), what),
                "library_ms": library_ms, "plain_and_library_cover": "dq + dk + dv",
                # the kernel's own count of the tiles it computed
                "tiles_computed_share": _counted_tiles_share(q, k, v, seg, seg, l, m, do, di, what),
                "max_abs_diff_library": lib_diff,
            }
            rows.append(row)
            log(f"kernel {json.dumps(row)}")
        del q, k, v, do, out, l, m, di
        torch.cuda.empty_cache()
    for row in state.get("kernels", []):  # the forward's rows, where the ingest phase made them
        if row["name"] == "K5 bf16":
            row["launches_training"] = sum(r["launches"]["K5 bf16"] for r in runs)
        elif row["name"] == "K5 f32":  # f32 encoders only: this phase's f32 gradient check is its main path
            row["launches"] = state["train"]["gradient_cosine"]["f32 InfoNCE"]["launches"]["K5 f32"]
    state.setdefault("kernels", []).extend(rows)


def phase_train(state: dict) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
    _train_full_width(state, dev, gen)
    _gradient_routes_agree(state, dev, gen)
    _train_short_rows(state, dev)
    _rerank_full_width(state, dev, gen)
    _k5_backward_times_and_rows(state, dev, gen)


# ------------------------------------------------------------------ phase 8

QUERY_SEED = 8
N_QUERY_FAKE, N_QUERY_DECODER = 16, 8
DECODER_MAX_TOKENS = 64
# the decoder's requests cut the context so that the prompt's bytes fit the
# 1,024 bucket: with 2,048 positions the bucket of a longer prompt leaves
# room for one new token (the JAX provider's budget rule)
DECODER_CONTEXT_CHARS = 600
PREFILL_BUCKETS = (512, 1024, 2048)
DECODE_PROMPT, DECODE_STEPS = 1024, 64
# cached decode against a full forward on the bf16 TinyLlama-width model:
# every product's output is rounded to bf16 (2^-8 relative) and a single-row
# step runs other GEMM kernels than a 64-row prefill, so the two routes round
# differently in each of 22 layers; bar: max |diff| within 5 % of the largest
# |logit| and cosine >= 0.999 per position (the f32 copy is held to 1e-4)
BF16_CACHE_REL, BF16_CACHE_COS = 0.05, 0.999
# BM25 carries the quotes: Zipf pseudo-words lie outside encoder_mid's training
# text, and at the default 0.3 / 0.7 a quoted chunk missing from the dense
# candidates keeps only the BM25 share and can drop out of the fused list
# (``quotes_first_at_default_weights`` reads how often); phase 6 does the same
QUERY_WEIGHTS = {"BM25_WEIGHT": "0.7", "VECTOR_WEIGHT": "0.3"}
_QUERY_ENV_DEFAULTS = ("CHUNK_MAX_CHARS", "CHUNK_TARGET_CHARS", "CHUNK_MIN_CHARS", "CHUNK_OVERLAP_CHARS",
                       "BM25_WEIGHT", "VECTOR_WEIGHT", "EMBED_PACK_WIDTH", "GEMINI_API_KEY", "LLM_MODEL_PATH",
                       "LLM_CONTINUOUS_SLOTS", "LLM_SPECULATIVE_GAMMA", "MAX_CONTEXT_LENGTH", "TOP_PAGES")


def _query(port: int, body: dict) -> tuple[float, dict]:
    t0 = time.perf_counter()
    out = _http(port, "POST", "/query", json.dumps(body).encode(), "application/json")
    return time.perf_counter() - t0, out


def _answered_timings(spans) -> list[dict[str, float]]:
    """Seconds of ``retrieve`` and ``generate`` of each query the LLM
    answered, from the service's ``query.retrieve`` / ``query.generate``
    spans (``observability.collect_spans``) by trace: a cache hit opens
    neither, a streamed answer no ``query.generate``."""
    by_trace: dict[int, dict[str, float]] = {}
    for s in spans:
        if s.name in ("query.retrieve", "query.generate"):
            by_trace.setdefault(s.trace, {})[s.name.split(".")[1]] = (s.end_ns - s.start_ns) / 1e9
    return [t for t in by_trace.values() if "generate" in t]


def _query_sse(port: int, body: dict) -> list[tuple[str, object]]:
    """``POST /query`` with ``stream: true``: the server-sent events in order."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}/query", data=json.dumps({**body, "stream": True}).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=600) as resp:
        if not resp.headers["Content-Type"].startswith("text/event-stream"):
            raise AssertionError(f"stream: true answered {resp.headers['Content-Type']}")
        text = resp.read().decode()
    events = []
    for block in text.strip().split("\n\n"):
        name, data = block.split("\n", 1)
        events.append((name.removeprefix("event: "), json.loads(data.removeprefix("data: "))))
    return events


def _quoted_sentences(store, names: dict[str, str], rng, n: int) -> list[tuple[str, str, int]]:
    """``n`` quotes from distinct chunks, ``(sentence, file name, 1-based
    page)``: sentences of 8+ words, each in exactly one chunk, that name
    their chunk: at least 4 distinct terms that occur in at most 3 chunks.
    (Zipf pseudo-word sentences made of the corpus's commonest words match
    dozens of chunks alike; no ranking can tell their source.)"""
    from intool_rag_tpu_torch.index.analyzer import tokenize

    split = re.compile(r"(?<=[.!?])\s+")
    counts: dict[str, int] = {}
    df: dict[str, int] = {}
    for text in store.texts:
        for sent in split.split(text):
            counts[sent.strip()] = counts.get(sent.strip(), 0) + 1
        for term in set(tokenize(text)):
            df[term] = df.get(term, 0) + 1

    def names_its_chunk(sent: str) -> bool:
        return (len(sent.split()) >= 8 and sent.endswith(".") and counts[sent] == 1
                and sum(df.get(t, 0) <= 3 for t in set(tokenize(sent))) >= 4)

    out = []
    for row in rng.permutation(len(store)):
        sents = [x.strip() for x in split.split(store.texts[row]) if names_its_chunk(x.strip())]
        if sents:
            out.append((sents[int(rng.integers(len(sents)))], names[store.doc_ids[row]], int(store.pages[row]) + 1))
        if len(out) == n:
            return out
    raise AssertionError(f"phase 8: only {len(out)} quotable sentences in the corpus")


def _counting(module, name: str):
    """Replace ``module.name`` by a wrapper that counts its calls; returns
    the count box and the original."""
    original = getattr(module, name)
    box = {"calls": 0}

    def counted(*args, **kwargs):
        box["calls"] += 1
        return original(*args, **kwargs)

    setattr(module, name, counted)
    return box, original


def _query_fake(provider, uploads, tmp: str) -> dict:
    """``LLM_PROVIDER=fake``: ingest phase 6's documents through
    ``POST /ingest``, then 16 concurrent quoting ``/query`` requests (the
    main path: counts set to 0 just before, read just after), a cache hit
    and one streamed answer over HTTP."""
    from intool_rag_tpu_torch import config
    from intool_rag_tpu_torch.llm import factory
    from intool_rag_tpu_torch.llm.semantic import factory as semantic
    from intool_rag_tpu_torch.observability import collect_spans
    from intool_rag_tpu_torch.ops import flat_fused
    from intool_rag_tpu_torch.providers.fake import FakeLLM
    from intool_rag_tpu_torch.service.app import RAGService
    from intool_rag_tpu_torch.service.http import ServiceServer

    config.reset_config()
    factory.reset_llm()
    semantic.reset_semantic_analyzer()
    service = RAGService(provider, device=DEVICE)
    server = ServiceServer(service, host="127.0.0.1", port=0)
    server.start_background()
    plain_k1, orig_k1 = _counting(flat_fused, "partial_topk_reference")
    plain_k2, orig_k2 = _counting(flat_fused, "partial_topk_int8_reference")
    try:
        for project, doc_id, name, data, mode in uploads:
            _upload(server.port, project, doc_id, name, data, mode)
        store = service.registry.store
        names = {doc_id: name for _, doc_id, name, _, _ in uploads}
        quotes = _quoted_sentences(store, names, np.random.default_rng(QUERY_SEED), N_QUERY_FAKE)
        _query(server.port, {"question": "warm up the query path"})
        if not isinstance(service.llm, FakeLLM):
            raise AssertionError(f"LLM_PROVIDER=fake served {type(service.llm).__name__}")
        with collect_spans() as spans:
            # ---- the main path: counts set to 0 just before, read just after
            _reset_launches()
            plain_k1["calls"] = plain_k2["calls"] = 0
            t0 = time.perf_counter()
            with ThreadPoolExecutor(max_workers=N_QUERY_FAKE) as pool:
                results = list(pool.map(lambda q: _query(server.port, {"question": q[0]}), quotes))
            wall = time.perf_counter() - t0
            launches, plain_calls = _launches(), plain_k1["calls"] + plain_k2["calls"]
            hits = service.query_cache.hits
            _, again = _query(server.port, {"question": quotes[0][0]})
            cache_hit = service.query_cache.hits == hits + 1 and again == results[0][1]
            events = _query_sse(server.port, {"question": quotes[1][0]})
        timings = _answered_timings(spans)
        # a reading, not the main path: the quoted chunk first at the default weights
        os.environ.update({"BM25_WEIGHT": "0.3", "VECTOR_WEIGHT": "0.7"})
        config.reset_config()
        first_at_default = sum(
            any(sentence in c.text for c in service.retriever.retrieve_chunks(sentence)[:1]) for sentence, _, _ in quotes)
        os.environ.update(QUERY_WEIGHTS)
        config.reset_config()
    finally:
        flat_fused.partial_topk_reference, flat_fused.partial_topk_int8_reference = orig_k1, orig_k2
        server.shutdown()
        service.tasks.shutdown()
    if set(launches) != {"K1 bf16 precise"} or plain_calls:
        raise AssertionError(f"phase 8 fake: /query launched {launches}, plain versions called {plain_calls} times")
    for (sentence, name, page), (_, body) in zip(quotes, results):
        first = body["sources"][0] if body["sources"] else {}
        if sentence not in body["answer"] or (first.get("source_file"), first.get("page")) != (name, page):
            raise AssertionError(f"phase 8 fake: quote from {name} p{page} answered {body['answer'][:120]!r}, "
                                 f"first source {first}")
    if not cache_hit:
        raise AssertionError("phase 8 fake: the repeated /query was not a cache hit with an equal body")
    kinds = [k for k, _ in events]
    if kinds[0] != "sources" or kinds[-1] != "done" or "token" not in kinds or "error" in kinds:
        raise AssertionError(f"phase 8 fake: stream events {kinds}")
    lat = sorted(r[0] for r in results)
    out = {
        "requests": len(results), "documents": len(uploads), "chunks": len(store), "wall_s": wall,
        "p50_ms": 1000 * float(np.median(lat)), "max_ms": 1000 * lat[-1], "qps": len(results) / wall,
        "retrieve_p50_ms": 1000 * float(np.median([t["retrieve"] for t in timings])),
        "generate_p50_ms": 1000 * float(np.median([t["generate"] for t in timings])),
        "launches": launches, "plain_calls": plain_calls, "cache_hit": cache_hit,
        "quotes_first_at_default_weights": first_at_default,
        "stream_events": {k: kinds.count(k) for k in dict.fromkeys(kinds)}, "card": card_line(),
    }
    log(f"phase 8 /query, fake LLM: {json.dumps(out)}")
    return {**out, "quotes": quotes}


def _cache_vs_full(model, ids: torch.Tensor, prefill: int, positions: torch.Tensor | None = None,
                   valid: torch.Tensor | None = None) -> tuple[float, float, float]:
    """``(max |diff|, max |logit|, min cosine over positions)`` between one
    full forward and a prefill of ``prefill`` tokens followed by single-token
    steps through the cache. ``positions`` and ``valid`` default to
    ``0..S-1`` and all valid; given a served request's (left padding at
    position 0, masked), the padding's logits are left out."""
    from intool_rag_tpu_torch.models.decoder import init_cache

    b, s = ids.shape
    pos = torch.arange(s, device=ids.device).expand(b, s) if positions is None else positions
    valid = torch.ones_like(ids, dtype=torch.bool) if valid is None else valid.bool()
    with torch.no_grad():
        full = model(ids, pos, init_cache(model.config, b, ids.device), valid)
        cache = init_cache(model.config, b, ids.device)
        parts = [model(ids[:, :prefill], pos[:, :prefill], cache, valid[:, :prefill])]
        for t in range(prefill, s):
            parts.append(model(ids[:, t : t + 1], pos[:, t : t + 1], cache, valid[:, t : t + 1]))
    step, full = torch.cat(parts, dim=1)[valid], full[valid]
    cos = torch.nn.functional.cosine_similarity(step, full, dim=-1).min()
    return float((step - full).abs().max()), float(full.abs().max()), float(cos)


def _served_replay(calls: list) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """One served request's decoder inputs, as the forward hook saw them:
    ``(ids, positions, valid [1, S + n], prefill S)``, its left-padded prompt
    followed by the ``n`` tokens fed to its decode steps."""
    if len(calls) < 2 or calls[0][0][1] == 1 or any(shape[1] != 1 for shape, *_ in calls[1:]):
        raise AssertionError(f"phase 8: one request's forwards are {[shape for shape, *_ in calls]}")
    ids = torch.cat([c[2] for c in calls], dim=1)
    pos = torch.cat([c[3] for c in calls], dim=1)
    valid = torch.cat([c[4] if c[4] is not None else torch.ones_like(c[2], dtype=torch.bool) for c in calls], dim=1)
    return ids, pos, valid.bool(), calls[0][0][1]


def _decoder_checks(llm, dev, served: tuple) -> dict:
    """Not the main path: cached decode against a full forward on a 2-layer
    f32 copy of the TinyLlama width (1e-4), and on the bf16 model (the
    ``BF16_CACHE_*`` bars) both at prefill 64 and on a served request's own
    inputs (:func:`_served_replay`: the padded 1,024 bucket, positions from
    the mask's running count, then the tokens it decoded), and the tiny f32
    config's greedy tokens on the card against the CPU's."""
    import dataclasses

    from intool_rag_tpu_torch.models.decoder import DecoderConfig, DecoderLM, generate, init_decoder_params

    gen = torch.Generator(device=dev).manual_seed(QUERY_SEED)
    cfg2 = dataclasses.replace(DecoderConfig.tinyllama(), num_layers=2, dtype="float32")
    small = DecoderLM(cfg2, device=dev).init_random(gen).eval()
    ids = torch.randint(3, cfg2.vocab_size, (2, 80), generator=gen, device=dev)
    f32_err, f32_max, f32_cos = _cache_vs_full(small, ids, 64)
    del small
    bf_err, bf_max, bf_cos = _cache_vs_full(llm.model, ids[:1], 64)
    s_ids, s_pos, s_valid, s_prefill = served
    sv_err, sv_max, sv_cos = _cache_vs_full(llm.model, s_ids, s_prefill, s_pos, s_valid)
    pad_slots = int((~s_valid[:, :s_prefill]).sum())
    tiny = DecoderConfig.tiny()
    state = init_decoder_params(tiny, torch.Generator().manual_seed(QUERY_SEED))
    cpu, card = DecoderLM(tiny, device="cpu").eval(), DecoderLM(tiny, device=dev).eval()
    cpu.load_state_dict(state)
    card.load_state_dict(state)
    rng = np.random.default_rng(QUERY_SEED)
    t_ids = torch.as_tensor(rng.integers(3, tiny.vocab_size, (4, 16)))
    t_mask = torch.ones((4, 16), dtype=torch.int32)
    for row, pad in enumerate((0, 5, 9, 2)):
        t_mask[row, :pad] = 0
        t_ids[row, :pad] = 0
    want = generate(cpu, t_ids, t_mask, max_new_tokens=24)
    got = generate(card, t_ids.to(dev), t_mask.to(dev), max_new_tokens=24).cpu()
    out = {"f32_2_layers_max_abs": f32_err, "f32_max_logit": f32_max, "f32_min_cosine": f32_cos,
           "bf16_max_abs": bf_err, "bf16_max_logit": bf_max, "bf16_rel": bf_err / bf_max, "bf16_min_cosine": bf_cos,
           "served_prompt": s_prefill, "served_pad_slots": pad_slots, "served_steps": s_ids.shape[1] - s_prefill,
           "served_max_abs": sv_err, "served_max_logit": sv_max, "served_rel": sv_err / sv_max,
           "served_min_cosine": sv_cos, "tiny_greedy_card_equals_cpu": bool(torch.equal(got, want))}
    log(f"phase 8 decoder checks on the card: {json.dumps(out)}")
    if f32_err > 1e-4 or bf_err > BF16_CACHE_REL * bf_max or bf_cos < BF16_CACHE_COS or not torch.equal(got, want) \
            or sv_err > BF16_CACHE_REL * sv_max or sv_cos < BF16_CACHE_COS or pad_slots == 0:
        raise AssertionError(f"phase 8: decoder checks failed: {out}")
    return out


def _decoder_timings(llm, dev) -> dict:
    """Prefill ms at each bucket (CUDA events, a preallocated cache), decode
    ms per token at batch 1 after a 1,024-token prompt (wall clock through
    ``generate``: 65 new tokens less 1), and the weight-read bound."""
    from intool_rag_tpu_torch.models.decoder import generate, init_cache

    model, cfg = llm.model, llm.config
    gen = torch.Generator(device=dev).manual_seed(QUERY_SEED + 1)
    prefill = {}
    with torch.no_grad():
        for s in PREFILL_BUCKETS:
            ids = torch.randint(3, 259, (1, s), generator=gen, device=dev)
            pos = torch.arange(s, device=dev)[None]
            cache = init_cache(cfg, 1, dev)

            def run(ids=ids, pos=pos, cache=cache):
                cache.length = 0
                model(ids, pos, cache)

            prefill[s] = cuda_ms(run, iters=5, warmup=2)
    ids = torch.randint(3, 259, (1, DECODE_PROMPT), generator=gen, device=dev)
    mask = torch.ones_like(ids)

    def wall(n: int) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generate(model, ids, mask, max_new_tokens=n)
        torch.cuda.synchronize()
        return 1000 * (time.perf_counter() - t0)

    wall(DECODE_STEPS + 1)
    one = float(np.median([wall(1) for _ in range(3)]))
    full = float(np.median([wall(DECODE_STEPS + 1) for _ in range(3)]))
    ms_per_token = (full - one) / DECODE_STEPS
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    bound_ms = 1000 * weight_bytes / H100_HBM_BYTES_S
    return {
        "prefill_ms": {str(s): ms for s, ms in prefill.items()},
        "decode_prompt": DECODE_PROMPT, "decode_steps": DECODE_STEPS,
        "generate_1_token_ms": one, f"generate_{DECODE_STEPS + 1}_tokens_ms": full,
        "decode_ms_per_token": ms_per_token, "tokens_per_s": 1000 / ms_per_token,
        "weight_bytes": weight_bytes, "weight_read_bound_ms": bound_ms, "bound_share": bound_ms / ms_per_token,
    }


def _query_decoder(provider, quotes, tmp: str, dev) -> tuple[dict, object]:
    """``LLM_PROVIDER=cuda`` at TinyLlama width: the factory's choice is
    checked, then the service answers 8 concurrent ``/query`` requests with
    ``CudaLLM(DecoderConfig.tinyllama())`` (seeded random weights, byte
    tokenizer, temperature 0, 64 new tokens) over the store the fake run
    ingested, the query cache off; the same question twice answers alike."""
    from intool_rag_tpu_torch import config
    from intool_rag_tpu_torch.llm import factory
    from intool_rag_tpu_torch.models.decoder import DecoderConfig
    from intool_rag_tpu_torch.observability import collect_spans
    from intool_rag_tpu_torch.providers.cuda_llm import CudaLLM
    from intool_rag_tpu_torch.service.app import RAGService
    from intool_rag_tpu_torch.service.http import ServiceServer

    os.environ.update({"LLM_PROVIDER": "cuda", "LLM_TEMPERATURE": "0", "LLM_MAX_TOKENS": str(DECODER_MAX_TOKENS),
                       "CACHE_DIR": os.path.join(tmp, "cache-decoder"), "CACHE_QUERY_RESULTS": "0"})
    config.reset_config()
    factory.reset_llm()
    chosen = factory.get_llm(DEVICE)
    if not isinstance(chosen, CudaLLM) or chosen.device.type != dev.type:
        raise AssertionError(f"LLM_PROVIDER=cuda built {type(chosen).__name__} on {getattr(chosen, 'device', None)}")
    factory.reset_llm()
    del chosen
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    llm = CudaLLM(config=DecoderConfig.tinyllama(), device=DEVICE)
    build_s = time.perf_counter() - t0
    params = list(llm.model.parameters())
    if any(p.device.type != dev.type or p.dtype != torch.bfloat16 for p in params):
        raise AssertionError("phase 8: the decoder's parameters are not bf16 on the card")
    # (input shape, cache device, ids, positions, valid mask or None): a
    # decode step's ids are the token generated before it
    calls: list[tuple] = []
    hook = llm.model.register_forward_pre_hook(lambda _m, args: calls.append(
        (tuple(args[0].shape), args[2].k.device, args[0].clone(), args[1].clone(),
         args[3].clone() if len(args) > 3 else None)))

    def fed_tokens() -> list[int]:
        return torch.cat([c[2].flatten() for c in calls if c[0][1] == 1]).tolist()

    service = RAGService(provider, device=DEVICE, llm=llm)
    server = ServiceServer(service, host="127.0.0.1", port=0)
    server.start_background()
    body = lambda q: {"question": q, "max_context_length": DECODER_CONTEXT_CHARS}  # noqa: E731
    try:
        _query(server.port, body("warm up the decoder"))
        calls.clear()
        with collect_spans() as spans:
            # ---- the main path: counts set to 0 just before, read just after
            _reset_launches()
            t0 = time.perf_counter()
            with ThreadPoolExecutor(max_workers=N_QUERY_DECODER) as pool:
                results = list(pool.map(lambda q: _query(server.port, body(q[0])), quotes[:N_QUERY_DECODER]))
            wall = time.perf_counter() - t0
            launches = _launches()
        timings = _answered_timings(spans)
        forwards = list(calls)
        twice, twice_tokens = [], []
        for _ in range(2):  # the query cache is off: both go through the decoder
            calls.clear()
            twice.append(_query(server.port, body(quotes[0][0]))[1]["answer"])
            twice_tokens.append(fed_tokens())
        served = _served_replay(calls)
    finally:
        server.shutdown()
        service.tasks.shutdown()
        hook.remove()
    prefills = [c[0] for c in forwards if c[0][1] > 1]
    steps = sum(1 for c in forwards if c[0][1] == 1)
    if "K1 bf16 precise" not in launches or any(c[1].type != dev.type for c in forwards):
        raise AssertionError(f"phase 8 decoder: launches {launches}, cache devices "
                             f"{sorted({str(c[1]) for c in forwards})}")
    if len(prefills) != N_QUERY_DECODER or any(not isinstance(b["answer"], str) or not b["sources"]
                                               for _, b in results):
        raise AssertionError(f"phase 8 decoder: {len(prefills)} prefills for {N_QUERY_DECODER} requests")
    if twice[0] != twice[1] or twice[0] != results[0][1]["answer"] or twice_tokens[0] != twice_tokens[1] \
            or len(twice_tokens[0]) < 1:
        raise AssertionError(f"phase 8 decoder: one question, answers {twice} / {results[0][1]['answer']!r}, "
                             f"tokens {[t[:8] for t in twice_tokens]}")
    lat = sorted(r[0] for r in results)
    out = {
        "config": "tinyllama (22 x 2048, 32 heads over 4 KV heads, 5632, vocab 32000, 2048 positions, bf16)",
        "build_s": build_s, "parameters": sum(p.numel() for p in params), "requests": len(results),
        "wall_s": wall, "p50_ms": 1000 * float(np.median(lat)), "max_ms": 1000 * lat[-1],
        "retrieve_p50_ms": 1000 * float(np.median([t["retrieve"] for t in timings])),
        "generate_p50_ms": 1000 * float(np.median([t["generate"] for t in timings])),
        "prefill_shapes": sorted(set(prefills)), "tokens_per_request": 1 + steps / len(prefills),
        "answer_chars": [len(b["answer"]) for _, b in results], "launches": launches,
        # random weights over 32,000 ids: few fall in the byte tokenizer's 3-258, so answers are mostly empty
        "same_question_tokens": twice_tokens[0][:16],
    }
    out.update(_decoder_timings(llm, dev))
    out["checks"] = _decoder_checks(llm, dev, served)
    out["peak_mb"] = torch.cuda.max_memory_allocated() / 1e6
    out["card"] = card_line()
    log(f"phase 8 /query, TinyLlama-width decoder: {json.dumps(out)}")
    return out, llm


def phase_query(state: dict) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    from intool_rag_tpu_torch.providers.cuda_embed import CudaEmbeddingProvider

    for name in _QUERY_ENV_DEFAULTS:
        os.environ.pop(name, None)
    packed_uploads, _ = _ingest_documents()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_query_") as tmp:
        # a fresh store and query cache: an earlier run's answers must not serve this one
        os.environ.update({"STORAGE_DIR": os.path.join(tmp, "storage"), "CACHE_DIR": os.path.join(tmp, "cache-fake"),
                           "CACHE_QUERY_RESULTS": "1", "CACHE_EMBEDDINGS": "1", "LLM_PROVIDER": "fake",
                           "INDEX_DTYPE": "bfloat16", "INDEX_KIND": "flat", "IVF_REFINE_K": "0", "DENSE_INT8": "0",
                           "DENSE_INT8_RESIDUAL": "0", "USE_PALLAS": "1", "EMBED_PACKED": "0",
                           "EMBEDDING_QUERY_INSTRUCTION": "", **QUERY_WEIGHTS})
        provider = CudaEmbeddingProvider(checkpoint=str(ENCODER_MID), device=DEVICE)
        fake = _query_fake(provider, packed_uploads, tmp)
        decoder, llm = _query_decoder(provider, fake.pop("quotes"), tmp, torch.device(DEVICE))
    launches = {name: fake["launches"].get(name, 0) + decoder["launches"].get(name, 0)
                for name in {*fake["launches"], *decoder["launches"]}}
    for row in state.get("kernels", []):
        row["launches_query"] = launches.get(row["name"], 0)
    state["query"] = {"fake": fake, "decoder": decoder, "launches": launches}
    state["decode_llm"] = llm  # its busy share is profiled after the last phase


def decode_busy_share(state: dict) -> None:
    """The device's busy share of a decode step and the launches per token,
    from ``torch.profiler`` over ``generate`` with 1 and 65 new tokens (the
    difference is 64 decode steps), against the unprofiled ms per token."""
    from intool_rag_tpu_torch.models.decoder import generate

    llm = state.pop("decode_llm")
    dev = llm.device
    ids = torch.randint(3, 259, (1, DECODE_PROMPT), generator=torch.Generator(device=dev).manual_seed(QUERY_SEED),
                        device=dev)
    mask = torch.ones_like(ids)
    one = _profiled_kernels(lambda: generate(llm.model, ids, mask, max_new_tokens=1))
    full = _profiled_kernels(lambda: generate(llm.model, ids, mask, max_new_tokens=DECODE_STEPS + 1))
    dec = state["query"]["decoder"]
    if not full:
        dec["decode_profile"] = "not measured: torch.profiler reported no device time"
    else:
        busy = (sum(ms for _, ms, _ in full) - sum(ms for _, ms, _ in one)) / DECODE_STEPS
        launches = (sum(c for _, _, c in full) - sum(c for _, _, c in one)) / DECODE_STEPS
        top = sorted(full, key=lambda k: -k[1])[:8]
        dec["decode_profile"] = {
            "device_busy_ms_per_token": busy, "launches_per_token": launches,
            "ms_per_token": dec["decode_ms_per_token"], "device_busy_share": busy / dec["decode_ms_per_token"],
            "top_kernels_65_tokens": [{"name": n[:48], "ms": ms, "calls": c} for n, ms, c in top],
            "card": card_line(),
        }
    log(f"phase 8 decode step under torch.profiler: {json.dumps(dec['decode_profile'])}")
    del llm
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ phase 9

SERVED_SLOTS, SERVED_GAMMA = 8, 4
N_SERVED_SEARCH = 4
# the 2-layer f32 copy's run: prompts cut to their last 56 tokens (bucket 64),
# 64 new tokens, 4 slots for 8 requests and a cache of 192 positions, so
# that the refilled second wave compacts once (a history bucket of 128)
F32_PROMPT_TOKENS, F32_SLOTS, F32_MAX_POSITION = 56, 4, 192
# a prompt that repeats its context: drafts can be found in it
REPEAT_PROMPT = "Context:\n" + "The warranty covers parts and labour for two years from delivery. " * 12 + \
    "\n\nQuestion: What does the warranty cover?\n\nAnswer: The warranty covers"


def _agent(port: int, question: str) -> tuple[float, dict]:
    t0 = time.perf_counter()
    out = _http(port, "POST", "/agent/query", json.dumps({"question": question}).encode(), "application/json")
    return time.perf_counter() - t0, out


def _first_near_tie(model, ids: list[int], toks: list[int]) -> int:
    """The first generated position where the static path's top-2 logit
    margin is below ``BF16_CACHE_REL`` of its largest |logit| (one full
    forward over the prompt and the tokens, batch 1); ``len(toks)`` if none."""
    if not toks:
        return 0
    dev = model.embed.weight.device
    seq = torch.as_tensor([ids + toks[:-1]], device=dev)
    pos = torch.arange(seq.shape[1], device=dev)[None]
    from intool_rag_tpu_torch.models.decoder import init_cache

    with torch.no_grad():
        logits = model(seq, pos, init_cache(model.config, 1, dev, positions=seq.shape[1]))[0, len(ids) - 1:]
    top2 = torch.topk(logits, 2, dim=-1).values
    near = (top2[:, 0] - top2[:, 1]) < BF16_CACHE_REL * logits.abs().max(dim=-1).values
    return int(torch.nonzero(near)[0, 0]) if bool(near.any()) else len(toks)


def _static_tokens(model, ids: list[int], max_new: int, eos: int) -> list[int]:
    """``generate`` on one prompt alone, left-padded into its power-of-two
    bucket as the scheduler pads it, cut at EOS."""
    from intool_rag_tpu_torch.models.decoder import generate

    dev = model.embed.weight.device
    bucket = 1 << max(3, (len(ids) - 1).bit_length())
    arr = torch.zeros((1, bucket), dtype=torch.long, device=dev)
    mask = torch.zeros((1, bucket), dtype=torch.int32, device=dev)
    arr[0, bucket - len(ids):] = torch.as_tensor(ids, device=dev)
    mask[0, bucket - len(ids):] = 1
    toks = generate(model, arr, mask, max_new_tokens=max_new, eos_id=eos)[0].tolist()
    return toks[: toks.index(eos)] if eos in toks else toks


def _held_to_greedy(model, runs: list[tuple[list[int], list[int], list[int]]], what: str) -> dict:
    """Each ``(prompt ids, served tokens, static tokens)`` equal up to the
    static path's first near-tie; the share of positions equal overall."""
    checked = equal = total = 0
    prefixes = []
    for ids, got, want in runs:
        k = min(_first_near_tie(model, ids, want), len(want))
        if got[:k] != want[:k]:
            raise AssertionError(f"phase 9 {what}: tokens {got[:k + 2]} != static {want[:k + 2]} before the first "
                                 f"near-tie at {k}")
        prefixes.append(k)
        checked += k
        equal += sum(a == b for a, b in zip(got, want))
        total += max(len(got), len(want))
    return {"requests": len(runs), "checked_prefix": prefixes, "tokens_checked": checked,
            "share_equal": equal / max(total, 1)}


def _recording(llm, name: str, calls: list):
    """Wrap ``llm.<name>`` so that each call's arguments and result are kept."""
    original = getattr(llm, name)

    def recorded(*args):
        out = original(*args)
        calls.append((args, out))
        return out

    setattr(llm, name, recorded)


def _served_decoder(service, server, quotes, dev, phase8: dict | None) -> dict:
    """``LLM_CONTINUOUS_SLOTS=8`` then ``LLM_SPECULATIVE_GAMMA=4`` (one
    stream, then with the slots) at TinyLlama width behind ``/query``: 8
    concurrent requests each, every request's tokens held to the static
    ``generate`` of its prompt; the 2-layer f32 copy through the scheduler
    across a compaction, its tokens equal outright; ms a token on a prompt
    that repeats its context."""
    import dataclasses

    from intool_rag_tpu_torch import config
    from intool_rag_tpu_torch.models.decoder import DecoderConfig, DecoderLM, generate
    from intool_rag_tpu_torch.models.scheduler import ContinuousGenerator
    from intool_rag_tpu_torch.observability import collect_spans, get_metrics
    from intool_rag_tpu_torch.providers.cuda_llm import CudaLLM

    body = lambda q: {"question": q, "max_context_length": DECODER_CONTEXT_CHARS}  # noqa: E731
    cached, service.query_cache = service.query_cache, None  # every request goes through the decoder
    out: dict = {"card": card_line()}

    def build(slots: int, gamma: int) -> CudaLLM:
        os.environ.update({"LLM_CONTINUOUS_SLOTS": str(slots), "LLM_SPECULATIVE_GAMMA": str(gamma),
                           "LLM_TEMPERATURE": "0", "LLM_MAX_TOKENS": str(DECODER_MAX_TOKENS)})
        config.reset_config()
        llm = CudaLLM(config=DecoderConfig.tinyllama(), device=DEVICE)  # phase 8's seeded weights
        if (llm._waves is not None) != (slots > 0) or \
                (model is not None and not torch.equal(llm.model.lm_head.weight, model.lm_head.weight)):
            raise AssertionError(f"phase 9: slots {slots}, gamma {gamma}: another wave server or other weights")
        return llm

    def serve(llm, label: str) -> dict:
        service._llm = llm
        _query(server.port, body("warm up the decoder"))
        before = get_metrics().snapshot()
        with collect_spans() as spans:
            _reset_launches()
            t0 = time.perf_counter()
            with ThreadPoolExecutor(max_workers=N_QUERY_DECODER) as pool:
                results = list(pool.map(lambda q: _query(server.port, body(q[0])), quotes[:N_QUERY_DECODER]))
            wall = time.perf_counter() - t0
            launches = _launches()
        after = get_metrics().snapshot()
        if "K1 bf16 precise" not in launches or any(not b["sources"] for _, b in results):
            raise AssertionError(f"phase 9 {label}: launches {launches}, "
                                 f"sources {[len(b['sources']) for _, b in results]}")
        delta = {k: after["counters"].get(k, 0) - before["counters"].get(k, 0)
                 for k in ("llm_waves", "llm_wave_requests", "llm_wave_tokens", "llm_compactions", "llm_wave_errors")}
        timings = _answered_timings(spans)
        row = {"wall_s": wall, "p50_ms": 1000 * float(np.median([r[0] for r in results])),
               "generate_p50_ms": 1000 * float(np.median([t["generate"] for t in timings])),
               "retrieve_p50_ms": 1000 * float(np.median([t["retrieve"] for t in timings])), "launches": launches}
        if llm._waves is not None:
            if delta["llm_wave_errors"] or delta["llm_wave_requests"] != N_QUERY_DECODER:
                raise AssertionError(f"phase 9 {label}: wave counters {delta}")
            row.update(waves=delta["llm_waves"], compactions=delta["llm_compactions"],
                       wave_tokens=delta["llm_wave_tokens"])
            acc = after["latency_s"].get("llm.accepted_per_wave")
            if acc is not None:
                row["accepted_per_wave_p50"] = acc["p50"]
        return row

    eos = 2  # the byte tokenizer's
    model = None
    # ---- continuous batching: 8 slots, plain waves
    llm = build(SERVED_SLOTS, 0)
    submits: list = []
    _recording(llm._waves, "submit", submits)
    out["slots"] = serve(llm, "slots")
    runs = [(list(a[0]), out_toks, _static_tokens(llm.model, list(a[0]), a[1], eos))
            for a, out_toks in submits[-N_QUERY_DECODER:]]
    out["slots"]["parity"] = _held_to_greedy(llm.model, runs, "slots")
    out["slots"]["prompt_tokens"] = sorted({len(r[0]) for r in runs})
    statics = {tuple(r[0]): r[2] for r in runs}
    model = llm.model
    llm.close()
    # ---- one stream with prompt-lookup speculation
    llm = build(0, SERVED_GAMMA)
    spec_calls: list = []
    _recording(llm, "_speculative_ids", spec_calls)
    out["speculative_single"] = serve(llm, "speculative single stream")
    runs = []
    for (ids, mask, _), toks in spec_calls[-N_QUERY_DECODER:]:
        want = generate(llm.model, *_encoded_tensors(ids, mask, dev), max_new_tokens=len(toks), eos_id=eos)[0].tolist()
        runs.append(([int(t) for t, m in zip(ids[0], mask[0]) if m], toks[: toks.index(eos)] if eos in toks else toks,
                     want[: want.index(eos)] if eos in want else want))
    out["speculative_single"]["parity"] = _held_to_greedy(llm.model, runs, "speculative single stream")
    single = llm
    # ---- speculative waves over 8 slots
    llm = build(SERVED_SLOTS, SERVED_GAMMA)
    submits = []
    _recording(llm._waves, "submit", submits)
    out["speculative_slots"] = serve(llm, "speculative slots")
    runs = [(list(a[0]), toks, statics.get(tuple(a[0])) or _static_tokens(llm.model, list(a[0]), a[1], eos))
            for a, toks in submits[-N_QUERY_DECODER:]]
    out["speculative_slots"]["parity"] = _held_to_greedy(llm.model, runs, "speculative slots")
    f32_prompts = [ids[-F32_PROMPT_TOKENS:] for ids, _, _ in runs]
    # ---- a prompt that repeats its context: ms a token, plain against speculative
    rep: dict = {}
    encoded = single._encode_prompt(REPEAT_PROMPT)
    for label, fn in (("plain", lambda: generate(model, *_encoded_tensors(*encoded, dev),
                                                  max_new_tokens=DECODER_MAX_TOKENS)[0].tolist()),
                      ("speculative_single", lambda: single._speculative_ids(*encoded, SERVED_GAMMA)),
                      ("speculative_slots", lambda: llm._waves.submit(
                          llm.tokenizer.encode(REPEAT_PROMPT)[-512:], DECODER_MAX_TOKENS))):
        fn()
        before = get_metrics().snapshot()["latency_s"].get("llm.accepted_per_wave", {}).get("count", 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = fn()
        torch.cuda.synchronize()
        ms = 1000 * (time.perf_counter() - t0)
        rep[label] = {"ms": ms, "tokens": len(toks), "ms_per_token": ms / max(len(toks), 1)}
        if label == "speculative_slots":
            acc = get_metrics().snapshot()["latency_s"]["llm.accepted_per_wave"]
            rep[label]["accepted_per_wave_p50"] = acc["p50"]
            rep[label]["server_waves"] = acc["count"] - before
    if phase8 is not None:
        rep["phase8_decode_ms_per_token"] = phase8.get("decode_ms_per_token")
    out["repeating_prompt"] = rep
    llm.close()
    single.close()
    del llm, single
    # ---- the 2-layer f32 copy across a compaction: tokens equal outright
    cfg2 = dataclasses.replace(DecoderConfig.tinyllama(), num_layers=2, dtype="float32", max_position=F32_MAX_POSITION)
    small = DecoderLM(cfg2, device=dev).init_random(torch.Generator(device=dev).manual_seed(QUERY_SEED)).eval()
    got, stats = ContinuousGenerator(small, n_slots=F32_SLOTS, eos_id=eos).generate_many(f32_prompts,
                                                                                        DECODER_MAX_TOKENS)
    want = [_static_tokens(small, p, DECODER_MAX_TOKENS, eos) for p in f32_prompts]
    out["f32_2_layers"] = {"requests": len(f32_prompts), "slots": F32_SLOTS, "max_position": F32_MAX_POSITION,
                           "compactions": stats["compactions"], "equal": got == want,
                           "tokens": stats["total_tokens"]}
    if stats["compactions"] < 1 or got != want:
        raise AssertionError(f"phase 9 f32: compactions {stats['compactions']}, equal {got == want}")
    del small, model
    service.query_cache = cached
    service._llm = None
    torch.cuda.empty_cache()
    return out


def _encoded_tensors(ids: np.ndarray, mask: np.ndarray, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """``CudaLLM._encode_prompt``'s arrays as the tensors ``generate`` takes."""
    return torch.as_tensor(ids, dtype=torch.long, device=dev), torch.as_tensor(mask, device=dev)


def phase_served(state: dict) -> None:
    """Phase 9: the agent, continuous batching, speculation, ``/metrics``;
    the trace is taken after the last phase's timings (:func:`served_trace`)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    from intool_rag_tpu_torch import config
    from intool_rag_tpu_torch.llm import factory
    from intool_rag_tpu_torch.llm.semantic import factory as semantic
    from intool_rag_tpu_torch.ops import flat_fused
    from intool_rag_tpu_torch.providers.cuda_embed import CudaEmbeddingProvider
    from intool_rag_tpu_torch.providers.fake import FakeLLM
    from intool_rag_tpu_torch.service.app import RAGService
    from intool_rag_tpu_torch.service.http import ServiceServer

    for name in _QUERY_ENV_DEFAULTS:
        os.environ.pop(name, None)
    packed_uploads, _ = _ingest_documents()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_served_")
    os.environ.update({"STORAGE_DIR": os.path.join(tmp.name, "storage"), "CACHE_DIR": os.path.join(tmp.name, "cache"),
                       "CACHE_QUERY_RESULTS": "1", "CACHE_EMBEDDINGS": "1", "LLM_PROVIDER": "fake",
                       "INDEX_DTYPE": "bfloat16", "INDEX_KIND": "flat", "IVF_REFINE_K": "0", "DENSE_INT8": "0",
                       "DENSE_INT8_RESIDUAL": "0", "USE_PALLAS": "1", "EMBED_PACKED": "0",
                       "EMBEDDING_QUERY_INSTRUCTION": "", **QUERY_WEIGHTS})
    config.reset_config()
    factory.reset_llm()
    semantic.reset_semantic_analyzer()
    provider = CudaEmbeddingProvider(checkpoint=str(ENCODER_MID), device=DEVICE)
    service = RAGService(provider, device=DEVICE)
    server = ServiceServer(service, host="127.0.0.1", port=0)
    server.start_background()
    state["served_trace"] = (service, server, tmp)  # taken after every timing of the run
    plain_k1, orig_k1 = _counting(flat_fused, "partial_topk_reference")
    plain_k2, orig_k2 = _counting(flat_fused, "partial_topk_int8_reference")
    try:
        for project, doc_id, name, data, mode in packed_uploads:
            _upload(server.port, project, doc_id, name, data, mode)
        names = {doc_id: name for _, doc_id, name, _, _ in packed_uploads}
        quotes = _quoted_sentences(service.registry.store, names, np.random.default_rng(QUERY_SEED), N_QUERY_FAKE)
        if not isinstance(service.llm, FakeLLM):
            raise AssertionError(f"LLM_PROVIDER=fake served {type(service.llm).__name__}")
        _query(server.port, {"question": "warm up the query path"})
        _agent(server.port, "warm up the agent")
        with ThreadPoolExecutor(max_workers=N_QUERY_FAKE) as pool:
            answered = list(pool.map(lambda q: _query(server.port, {"question": q[0]}), quotes))
        first = [bool(b["sources"]) and (b["sources"][0].get("source_file"), b["sources"][0].get("page")) == (n, p)
                 and s in b["answer"] for (s, n, p), (_, b) in zip(quotes, answered)]
        for q in quotes[:N_SERVED_SEARCH]:
            _http(server.port, "POST", "/search", json.dumps({"question": q[0]}).encode(), "application/json")
        # ---- the main path: counts set to 0 just before, read just after
        _reset_launches()
        plain_k1["calls"] = plain_k2["calls"] = 0
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=N_QUERY_FAKE) as pool:
            results = list(pool.map(lambda q: _agent(server.port, q[0]), quotes))
        wall = time.perf_counter() - t0
        launches, plain_calls = _launches(), plain_k1["calls"] + plain_k2["calls"]
        health = _http(server.port, "GET", "/agent/health")
        metrics = _http(server.port, "GET", "/metrics")
    finally:
        flat_fused.partial_topk_reference, flat_fused.partial_topk_int8_reference = orig_k1, orig_k2
    if set(launches) != {"K1 bf16 precise"} or plain_calls:
        raise AssertionError(f"phase 9 agent: launched {launches}, plain versions called {plain_calls} times")
    gated = 0
    for (sentence, name, page), ok, (_, body) in zip(quotes, first, results):
        gated += "gate:rejected" in body["state"]["steps"]
        pages = [(s["source_file"], s["page"]) for s in body["all_sources"]]
        if ok and ((name, page) not in pages or sentence not in body["answer"]):
            raise AssertionError(f"phase 9 agent: quote from {name} p{page} answered {body['answer'][:120]!r}, "
                                 f"sources {pages}")
    counters = metrics["counters"]
    sent = {"agent_requests": 1 + N_QUERY_FAKE, "query_requests": 1 + N_QUERY_FAKE, "search_requests": N_SERVED_SEARCH}
    if health != {"status": "ok", "pipeline": "page-aware-agent"} or \
            any(counters.get(k) != v for k, v in sent.items()) or \
            metrics["latency_s"].get("agent.query", {}).get("count") != 1 + N_QUERY_FAKE:
        raise AssertionError(f"phase 9: /agent/health {health}, /metrics {json.dumps(metrics)[:600]}")
    lat = sorted(r[0] for r in results)
    agent = {"requests": len(results), "wall_s": wall, "p50_ms": 1000 * float(np.median(lat)),
             "max_ms": 1000 * lat[-1], "query_page_first": sum(first), "gated": gated, "launches": launches,
             "plain_calls": plain_calls, "agent_query_p50_s": metrics["latency_s"]["agent.query"]["p50"],
             "intents": sorted({b["intent"] for _, b in results}), "card": card_line()}
    log(f"phase 9 /agent/query, fake LLM: {json.dumps(agent)}")
    phase8 = state.get("query", {}).get("decoder")
    decoder = _served_decoder(service, server, quotes, torch.device(DEVICE), phase8)
    if phase8 is not None:
        decoder["phase8_queued"] = {k: phase8.get(k) for k in ("wall_s", "p50_ms", "generate_p50_ms")}
    log(f"phase 9 decoder, continuous batching and speculation: {json.dumps(decoder)}")
    launches = dict(agent["launches"])
    for run in ("slots", "speculative_single", "speculative_slots"):
        for name, n in decoder[run]["launches"].items():
            launches[name] = launches.get(name, 0) + n
    for row in state.get("kernels", []):
        row["launches_served"] = launches.get(row["name"], 0)
    state["served"] = {"agent": agent, "decoder": decoder, "launches": launches}


def served_trace(state: dict, windows: int = 1) -> None:
    """``POST /debug/trace`` (0.5 s) while ``/agent/query`` requests run:
    the trace file must exist and hold CUDA kernel events. After every
    timing of the run: a profiler window slows later host work. With
    ``windows`` > 1 (``--trace-windows``) the window repeats, with 1 and 4
    request threads in turn: the device gate must keep every start and
    stop of the profiler apart from the requests' launches."""
    import glob
    import threading

    service, server, tmp = state.pop("served_trace")
    readings = []
    try:
        for w in range(windows):
            stop = threading.Event()
            answered = []

            def agent_loop(stop, answered):
                while not stop.is_set():
                    answered.append(_agent(server.port, "what does the invoice part say about the report")[1])

            workers = [threading.Thread(target=agent_loop, args=(stop, answered)) for _ in range(1 if w % 2 == 0 else 4)]
            try:
                for worker in workers:
                    worker.start()
                time.sleep(0.2)
                out = _http(server.port, "POST", "/debug/trace", json.dumps({"seconds": 0.5}).encode(),
                            "application/json")
            finally:
                stop.set()
                for worker in workers:
                    worker.join()
            files = sorted(glob.glob(os.path.join(out["trace_dir"], "*.json")))
            events = json.loads(Path(files[-1]).read_text())["traceEvents"] if len(files) == w + 1 else []
            readings.append({"threads": len(workers), "files": len(files), "events": len(events),
                             "cuda_kernel_events": sum(1 for e in events if e.get("cat") == "kernel"),
                             "agent_query_ranges": sum(1 for e in events if e.get("name") == "agent.query"),
                             "agent_answers": len(answered)})
            if len(files) != w + 1 or not readings[-1]["cuda_kernel_events"] or not answered:
                raise AssertionError(f"phase 9 trace, window {w}: {readings[-1]}")
    finally:
        server.shutdown()
        service.tasks.shutdown()
        tmp.cleanup()
    trace = {"seconds": out["seconds"], **readings[0], "card": card_line()}
    if windows > 1:
        trace["windows"] = windows
        trace["min"] = {k: min(r[k] for r in readings) for k in ("events", "cuda_kernel_events", "agent_answers")}
    log(f"phase 9 /debug/trace: {json.dumps(trace)}")
    state.setdefault("served", {})["trace"] = trace


# ------------------------------------------------------------------ phase 10

# the JAX invoice eval's engine (tests/test_ocr_invoices.py), then the one
# the service's PDFOCRBridge builds (OCREngine's default det_limit)
SCAN_DET_LIMITS = (1280, 640)


def _scan_pages() -> tuple[bytes, list[list[str]], list[np.ndarray]]:
    from intool_rag_tpu_torch.ocr.pdf_ocr import extract_page_images
    from intool_rag_tpu_torch.ocr.synth import load_scanned_fixture

    pdf, truth = load_scanned_fixture()
    return pdf, truth, [extract_page_images(pdf, i)[0] for i in range(len(truth))]


def _timed_forwards(engine) -> list:
    """Wrap ``engine._forward``: each model forward appends (its model's
    name, its CUDA-event span in ms) to the returned list."""
    forward, spans = engine._forward, []
    names = {id(engine.bundle.det): "det", id(engine.bundle.cls): "cls", id(engine.bundle.rec): "rec"}

    def timed(model, batch):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = forward(model, batch)
        end.record()
        end.synchronize()
        spans.append((names[id(model)], start.elapsed_time(end)))
        return out

    engine._forward = timed
    return spans


def _ocr_card_and_cpu(state: dict, images, truth, det_limit: int) -> dict:
    """The shipped weights on the card and on the CPU over every page: per
    page wall s, ``elapse``, the forwards' CUDA-event span, the host time
    besides and the forwards; exact and fuzzy rates as
    ``evaluate_on_invoices`` scores them; the card's texts must equal the
    CPU's page by page."""
    from intool_rag_tpu_torch.ocr.eval import score_page
    from intool_rag_tpu_torch.ocr.models import OCRModelBundle
    from intool_rag_tpu_torch.ocr.pipeline import DEFAULT_WEIGHTS, OCREngine

    card = OCREngine(OCRModelBundle.load(DEFAULT_WEIGHTS), device=DEVICE, det_limit=det_limit)
    cpu = OCREngine(OCRModelBundle.load(DEFAULT_WEIGHTS), device="cpu", det_limit=det_limit)
    card(images[0])  # first call: cuDNN set-up, the bigram LM and the lexicon tables
    spans = _timed_forwards(card)
    pages, scores, mismatched = [], [], []
    for i, (img, gt) in enumerate(zip(images, truth)):
        del spans[:]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = card(img)
        wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = cpu(img)
        cpu_s = time.perf_counter() - t0
        span = sum(ms for _, ms in spans)
        forwards = {m: sum(1 for n, _ in spans if n == m) for m in ("det", "cls", "rec")}
        pages.append({"page": i, "s": wall, "elapse": got.elapse, "forward_span_ms": span,
                      "host_ms": 1000 * wall - span, "forwards": forwards, "lines": len(got.lines),
                      "cpu_s": cpu_s})
        scores.append(score_page(got.lines, gt))
        if [ln.text for ln in got.lines] != [ln.text for ln in want.lines]:
            mismatched.append(i)
            log(f"phase 10 det_limit {det_limit} page {i}: the card's lines differ from the CPU's\n"
                f"  card: {[ln.text for ln in got.lines]}\n  cpu:  {[ln.text for ln in want.lines]}")
    total = sum(sc["lines"] for sc in scores)
    wall = [p["s"] for p in pages]
    out = {
        "det_limit": det_limit, "pages": pages, "s_per_page": float(np.mean(wall)),
        "forward_span_share": sum(p["forward_span_ms"] for p in pages) / (1000 * sum(wall)),
        "exact_rate": sum(sc["exact"] for sc in scores) / total,
        "fuzzy_rate": sum(sc["fuzzy_sum"] for sc in scores) / total,
        "spurious_rate": sum(sc["spurious"] for sc in scores) / max(1, sum(sc["emitted"] for sc in scores)),
        "gt_lines": total, "pages_equal_to_cpu": len(images) - len(mismatched),
        "cudnn_allow_tf32_process": torch.backends.cudnn.allow_tf32, "card": card_line(),
    }
    log(f"phase 10 OCR on the card, det_limit {det_limit}: {json.dumps(out)}")
    if mismatched:
        raise AssertionError(f"phase 10 det_limit {det_limit}: pages {mismatched} read differently on the card")
    state.setdefault("scan_engines", {})[det_limit] = card
    return out


def _tf32_reading(engine, image) -> dict:
    """One page's forwards timed with cuDNN's TF32 off (the engine's
    setting) and on: a reading for later work, not used."""
    batches = []
    forward = engine._forward

    def recording(model, batch):
        batches.append((model, torch.from_numpy(batch).to(DEVICE)))
        return forward(model, batch)

    engine._forward = recording
    engine(image)
    engine._forward = forward
    out = {"forwards": len(batches)}
    for tf32 in (False, True):
        def run():
            with torch.inference_mode(), torch.backends.cudnn.flags(enabled=True, allow_tf32=tf32):
                for model, x in batches:
                    model(x)
        out["tf32" if tf32 else "f32"] = cuda_ms(run, iters=5)
    return out


def _scanned_ingest(state: dict, pdf: bytes, n_pages: int) -> dict:
    """``POST /ingest`` of the scanned PDF on the default configuration
    (``OCR_ENABLED`` unset) over an ``encoder_mid`` store; every page must
    come back OCR'd and non-empty, then ``/search`` for one recognised line
    of each page must find that page in the top 5 through K1."""
    from intool_rag_tpu_torch import config
    from intool_rag_tpu_torch.ingest import loader
    from intool_rag_tpu_torch.llm.semantic import factory as semantic
    from intool_rag_tpu_torch.ocr.pdf_ocr import PDFOCRBridge
    from intool_rag_tpu_torch.ops import flat_fused
    from intool_rag_tpu_torch.providers.cuda_embed import CudaEmbeddingProvider
    from intool_rag_tpu_torch.service.app import RAGService
    from intool_rag_tpu_torch.service.http import ServiceServer

    saved = dict(os.environ)
    os.environ.clear()
    os.environ.update(state["environ"])  # the default configuration: no setting of an earlier phase
    os.environ.pop("OCR_ENABLED", None)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_scan_")
    os.environ.update({"STORAGE_DIR": os.path.join(tmp.name, "storage"), "CACHE_DIR": os.path.join(tmp.name, "cache"),
                       "EMBEDDING_QUERY_INSTRUCTION": ""})  # encoder_mid was trained without one
    config.reset_config()
    semantic.reset_semantic_analyzer()
    provider = CudaEmbeddingProvider(checkpoint=str(ENCODER_MID), device=DEVICE)
    service = RAGService(provider, device=DEVICE)
    if not config.get_config().OCR_ENABLED or not isinstance(loader._ocr_engine, PDFOCRBridge):
        raise AssertionError("phase 10: the default configuration did not register the OCR fallback")
    pages: list = []
    load = service.pipeline.loader.load

    def recording(path):
        out = load(path)
        pages.extend(out)
        return out

    service.pipeline.loader.load = recording
    server = ServiceServer(service, host="127.0.0.1", port=0)
    server.start_background()
    plain_k1, orig_k1 = _counting(flat_fused, "partial_topk_reference")
    plain_k2, orig_k2 = _counting(flat_fused, "partial_topk_int8_reference")
    try:
        # ---- the main path: counts set to 0 just before, read just after
        _reset_launches()
        t0 = time.perf_counter()
        ingest = _upload(server.port, "scans", "scan", "scanned_invoices.pdf", pdf)
        ingest_s = time.perf_counter() - t0
        empty = [p.page for p in pages if not (p.has_ocr and p.raw_content.strip())]
        if ingest["total_pages"] != n_pages or len(pages) != n_pages or empty:
            raise AssertionError(f"phase 10: /ingest gave {ingest}; pages without OCR text: {empty}")
        texts = [p.raw_content for p in pages]
        found, queries = [], []
        for p in pages:  # each page's longest line that no other page holds
            lines = [ln.strip("| ") for ln in p.raw_content.splitlines()]
            own = [ln for ln in lines if ln and not any(ln in t for j, t in enumerate(texts) if j != p.page)]
            query = max(own or lines, key=len)
            hits = _http(server.port, "POST", "/search", json.dumps({"question": query}).encode(),
                         "application/json")["hits"]
            queries.append(query)
            found.append(p.page + 1 in [h["page"] for h in hits[:5]])  # /search numbers pages from 1
        launches, plain_calls = _launches(), plain_k1["calls"] + plain_k2["calls"]
    finally:
        flat_fused.partial_topk_reference, flat_fused.partial_topk_int8_reference = orig_k1, orig_k2
        server.shutdown()
        service.tasks.shutdown()
        tmp.cleanup()
        os.environ.clear()
        os.environ.update(saved)  # a later profiler window serves phase 9's service
        config.reset_config()
        semantic.reset_semantic_analyzer()
    engine = loader._ocr_engine.engine
    out = {"pages": n_pages, "ingest_wall_s": ingest_s, "s_per_page": ingest_s / n_pages,
           "chunks": ingest["total_chunks"], "mean_confidence": float(np.mean([p.extraction_confidence for p in pages])),
           "found_in_top5": sum(found), "launches": launches, "plain_calls": plain_calls,
           "engine_device": str(engine.device), "det_limit": engine.det_limit, "card": card_line()}
    log(f"phase 10 POST /ingest of the scanned PDF: {json.dumps(out)}")
    if not all(found) or "K1 bf16 precise" not in launches or plain_calls or engine.device.type != "cuda":
        missed = [q for q, f in zip(queries, found) if not f]
        raise AssertionError(f"phase 10 /search: missed {missed}, launched {launches}, plain calls {plain_calls}")
    for row in state.get("kernels", []):
        row["launches_scanned"] = launches.get(row["name"], 0)
    return out


def phase_scanned(state: dict) -> None:
    """Phase 10: the OCR fallback. The shipped det / cls / rec on the card
    against the CPU over the committed scanned fixture, then ``POST
    /ingest`` of it through the service on the default configuration."""
    torch.cuda.empty_cache()
    pdf, truth, images = _scan_pages()
    runs = [_ocr_card_and_cpu(state, images, truth, lim) for lim in SCAN_DET_LIMITS]
    tf32 = _tf32_reading(state["scan_engines"][SCAN_DET_LIMITS[0]], images[1])
    log(f"phase 10 one page's forwards, cuDNN TF32 off / on (a reading, not used): {json.dumps(tf32)}")
    ingest = _scanned_ingest(state, pdf, len(truth))
    state["scanned"] = {"ocr": runs, "tf32_reading_ms": tf32, "ingest": ingest}
    state["scan_profile_page"] = images[1]


def scanned_busy_share(state: dict) -> None:
    """The device's busy share of one page (det_limit 1280) from
    ``torch.profiler``, against the page's unprofiled wall time."""
    engine = state.pop("scan_engines")[SCAN_DET_LIMITS[0]]
    image = state.pop("scan_profile_page")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine(image)
    wall_ms = 1000 * (time.perf_counter() - t0)
    kernels = _profiled_kernels(lambda: engine(image))
    busy = sum(ms for _, ms, _ in kernels)
    profile = ("not measured: torch.profiler reported no device time" if not kernels else
               {"page_wall_ms": wall_ms, "device_busy_ms": busy, "device_busy_share": busy / wall_ms,
                "kernel_launches": sum(c for _, _, c in kernels),
                "top_kernels": [{"name": n[:48], "ms": ms, "calls": c}
                                for n, ms, c in sorted(kernels, key=lambda k: -k[1])[:6]],
                "card": card_line()})
    state["scanned"]["profile"] = profile
    log(f"phase 10 one page under torch.profiler: {json.dumps(profile)}")


# ------------------------------------------------------------------ phase 11

TIER_NLIST, TIER_NPROBES, TIER_SEG_ROWS = 4096, (8, 16, 32), 500_000
TIER_QUERY_CHUNK, TIER_SLICE = 32, 2048
TIER_SERVICE_DOCS = 24  # 6,000 chunks of phase 3's corpus: above the tiers' 4,096-row floor
PLAIN_VERSIONS = (("flat_fused", "partial_topk_reference"), ("flat_fused", "partial_topk_int8_reference"),
                  ("bits_scan", "bits_scan_reference"), ("quant", "quantize_int8_stochastic_reference"))


class _NoKernelOrPlain:
    """Over a block: every K1-K5 launch count set to 0 before and read
    after, and every plain version's calls counted; the block fails if any
    kernel launched or any plain version ran (the capacity tiers and the
    trainers have no TPU kernel: plain PyTorch on the card)."""

    def __init__(self, label: str) -> None:
        self.label = label

    def __enter__(self):
        import importlib

        from intool_rag_tpu_torch.ops.flash_attention import flash_attention_backward_plain, flash_attention_plain

        self.flash = (flash_attention_plain, flash_attention_backward_plain)
        self.boxes = []
        for mod, name in PLAIN_VERSIONS:
            module = importlib.import_module(f"intool_rag_tpu_torch.ops.{mod}")
            self.boxes.append((module, name, *_counting(module, name)))
        for fn in self.flash:
            fn.calls.reset()
        _reset_launches()
        return self

    def __exit__(self, *exc) -> None:
        for module, name, _, original in self.boxes:
            setattr(module, name, original)
        self.launches = _launches()
        self.plain_calls = sum(box["calls"] for _, _, box, _ in self.boxes) + sum(f.calls.count for f in self.flash)
        if exc[0] is None and (sum(self.launches.values()) or self.plain_calls):
            raise AssertionError(f"{self.label}: launched {self.launches}, plain versions called "
                                 f"{self.plain_calls} times; expected neither")


class _KmeansClock:
    """Times the k-means a tier module's build calls (synchronised)."""

    def __init__(self, module) -> None:
        self.module, self.seconds = module, 0.0

    def __enter__(self):
        self.original = self.module.kmeans

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.original(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            return out

        self.module.kmeans = timed
        return self

    def __exit__(self, *exc) -> None:
        self.module.kmeans = self.original


def _tier_corpus(centers: torch.Tensor) -> torch.Tensor:
    """Phase 5's 3M x d1024 corpus, whole on the card (f32, 12.3 GB): the
    JAX builds gather the corpus in f32 too."""
    out = torch.empty((CAP_ROWS, centers.shape[1]), dtype=torch.float32, device=centers.device)
    for c in range(CAP_ROWS // CAP_CHUNK):
        out[c * CAP_CHUNK : (c + 1) * CAP_CHUNK] = micro_chunk(1 + c, centers, CAP_CHUNK)
    return out


def _tier_bytes(index) -> tuple[int, int]:
    """(bytes on the card, bytes on the host) of a capacity tier."""
    if hasattr(index, "bytes_resident"):
        return index.bytes_resident, index.bytes_host
    arrays = (index.permuted, index.centroids, index.row_map, index.list_start, index.list_len)
    return sum(a.numel() * a.element_size() for a in arrays), 0


def _gather_sizes(cap: int) -> dict:
    """MB of the f32 rows ``[32, nprobe·cap, 1024]`` a query chunk of the
    JAX design gathers, and what a chunk gathers here (the chunk cut by
    ``ivf_residual.bounded_chunk``), at each nprobe; with the cut chunks."""
    from intool_rag_tpu_torch.index.ivf_residual import bounded_chunk

    out = {"jax_gather_mb": {}, "gather_mb": {}, "query_chunk": {}}
    for p in TIER_NPROBES:
        chunk = bounded_chunk(TIER_QUERY_CHUNK, p * cap, DIM)
        out["jax_gather_mb"][p] = TIER_QUERY_CHUNK * p * cap * DIM * 4 / 1e6
        out["gather_mb"][p] = chunk * p * cap * DIM * 4 / 1e6
        out["query_chunk"][p] = chunk
    return out


def _tier_search_runs(name: str, index, qs, q_sub, oracle, refine: bool) -> dict:
    """QPS at each nprobe (a batch of Q_SCALE, two batches after a
    warm-up), one more batch split into the device pass (the pool of
    CAP_POOL) and the host refine; recall@10 against the oracle; peak
    memory of a batch above what the corpus and the index hold."""
    from intool_rag_tpu_torch.index.bits_index import refine_from_host

    kw = {"refine_k": CAP_POOL} if refine else {}
    k_dev = CAP_POOL if refine else TOP_K
    out = {}
    for nprobe in TIER_NPROBES:
        search = lambda qv, k=TOP_K, **extra: index.search(qv, k, nprobe=nprobe, query_chunk=TIER_QUERY_CHUNK,
                                                           **{**kw, **extra})
        search(qs[3])  # warm-up: allocations, the host tier's concat
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        times = []
        for qv in qs[:2]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            search(qv)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        peak_mb = (torch.cuda.max_memory_allocated() - base) / 1e6
        # the same batch again, the device pass (its pool) and the host refine apart
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, pool = index.search(qs[0], k_dev, nprobe=nprobe, query_chunk=TIER_QUERY_CHUNK)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if refine:
            host = (index._host_cat if getattr(index, "_host_cat", None) is not None
                    else (index.host_int8, index.host_scale8))
            refine_from_host(qs[0], pool, TOP_K, *host)
            torch.cuda.synchronize()
        device_ms, refine_ms = [1000 * (t1 - t0)], [1000 * (time.perf_counter() - t1)]
        vals, rows = search(q_sub)
        if not (torch.isfinite(vals).all() and tuple(rows.shape) == (ORACLE_Q, TOP_K)):
            raise AssertionError(f"phase 11 {name} nprobe {nprobe}: malformed result")
        out[nprobe] = {
            "qps_mean": Q_SCALE / float(np.mean(times)), "qps_runs": [Q_SCALE / t for t in times],
            "ms_per_batch": 1000 * float(np.mean(times)), "device_pass_ms": float(np.mean(device_ms)),
            "host_refine_ms": float(np.mean(refine_ms)) if refine else None,
            "recall@10": _recall(rows.cpu().numpy(), oracle), "peak_mb": peak_mb,
        }
    return out


def _tier_card_vs_cpu(name: str, build, corpus: torch.Tensor, queries: torch.Tensor, module) -> float:
    """The tier built from the first TIER_SLICE rows on the card and on the
    CPU from the same k-means (the card's, handed to the CPU build): top-10
    rows equal as sets where scores tie, scores to 1e-4. Returns the
    largest score difference."""
    rows = corpus[:TIER_SLICE]
    original = module.kmeans
    fixed = {}

    def once(points, k, **kw):
        if "out" not in fixed:
            fixed["out"] = tuple(t.cpu() for t in original(points, k, **kw))
        return tuple(t.to(points.device) for t in fixed["out"])

    module.kmeans = once
    try:
        card, cpu = build(rows, torch.device(DEVICE)), build(rows.cpu(), torch.device("cpu"))
    finally:
        module.kmeans = original
    qv = queries[:64]
    gv, gr = (t.cpu().numpy() for t in card.search(qv, TOP_K, nprobe=16))
    wv, wr = (t.numpy() for t in cpu.search(qv.cpu(), TOP_K, nprobe=16))
    err = float(np.abs(gv - wv).max())
    if err > 1e-4:
        raise AssertionError(f"phase 11 {name}: card scores {err} from the CPU's")
    for a, b, v in zip(gr, wr, wv):
        for i in np.flatnonzero(a != b):
            tie = np.abs(v - v[i]) <= 1e-4
            if not tie[-1] and set(a[tie]) != set(b[tie]):
                raise AssertionError(f"phase 11 {name}: card rows {a} against the CPU's {b}")
    return err


def _tier_service(state: dict) -> dict:
    """``INDEX_KIND=segmented`` behind the HTTP service over 6,000
    ``encoder_mid`` chunks: the first ``/search`` builds the tier; ``POST
    /ingest`` of a new document appends a segment to the SAME index, and
    its quote is found (through the tier alone too); ``DELETE`` rebuilds."""
    from intool_rag_tpu_torch import config
    from intool_rag_tpu_torch.index.segmented_residual import SegmentedResidualIndex
    from intool_rag_tpu_torch.providers.cuda_embed import CudaEmbeddingProvider
    from intool_rag_tpu_torch.service.app import RAGService
    from intool_rag_tpu_torch.service.http import ServiceServer

    rng = np.random.default_rng(11)
    vocab, texts = _word_corpus(np.random.default_rng(1))
    texts = texts[: TIER_SERVICE_DOCS * CHUNKS_PER_DOC]
    new_doc = [" ".join(rng.choice(vocab[:5000], size=40)) + "." for _ in range(12)]
    saved = dict(os.environ)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_tiers_")
    os.environ.update({"STORAGE_DIR": tmp.name, "CACHE_DIR": os.path.join(tmp.name, "cache"), "INDEX_KIND": "segmented",
                       "IVF_RESIDUAL_BITS": "1", "IVF_REFINE_K": "100", "INDEX_DTYPE": "bfloat16",
                       "EMBEDDING_QUERY_INSTRUCTION": "", **QUERY_WEIGHTS})
    config.reset_config()
    provider = CudaEmbeddingProvider(checkpoint=str(ENCODER_MID), device=DEVICE)
    _write_storage(Path(tmp.name), texts, provider, n_docs=TIER_SERVICE_DOCS)
    service = RAGService(provider, device=DEVICE)
    server = ServiceServer(service, host="127.0.0.1", port=0)
    server.start_background()
    try:
        with _NoKernelOrPlain("phase 11 service"):
            search = lambda q: _http(server.port, "POST", "/search", json.dumps({"question": q}).encode(),
                                     "application/json")["hits"]
            t0 = time.perf_counter()
            first = search(texts[123])
            first_s = time.perf_counter() - t0
            dense = service.registry.engine.dense
            tier = dense._ivf
            if not isinstance(tier, SegmentedResidualIndex) or dense.routes_flat() or tier.device.type != DEVICE:
                raise AssertionError(f"phase 11 service: /search did not build a segmented tier on the card ({tier})")
            before = (tier.n_segments, tier.total_rows)
            t0 = time.perf_counter()
            ingest = _upload(server.port, "tiers", "fresh", "fresh.txt", "\n\n".join(new_doc).encode())
            ingest_s = time.perf_counter() - t0
            quote = new_doc[5]
            hits = search(quote)
            after_tier = service.registry.engine.dense._ivf
            store = service.registry.store
            if after_tier is not tier or tier.n_segments <= before[0] or tier.total_rows != len(store):
                raise AssertionError(f"phase 11 service: ingest did not append to the same tier "
                                     f"({before} -> {tier.n_segments, tier.total_rows})")
            # the appended rows are searchable through the tier alone: each new
            # chunk's own stored vector finds that chunk first
            new_rows = store.rows_for_doc("fresh")
            _, dense_rows = service.registry.engine.dense.search(store.embeddings[new_rows], 1)
            if "fresh" not in [h["doc_id"] for h in hits[:5]] or dense_rows[:, 0].tolist() != new_rows:
                raise AssertionError(f"phase 11 service: the new document was not found ({hits[:5]}; "
                                     f"tier top-1 {dense_rows[:, 0].tolist()} for rows {new_rows})")
            _http(server.port, "DELETE", "/documents/fresh")
            gone = search(quote)
            rebuilt = service.registry.engine.dense._ivf
            if rebuilt is tier or any(h["doc_id"] == "fresh" for h in gone):
                raise AssertionError("phase 11 service: DELETE did not rebuild the tier")
    finally:
        server.shutdown()
        service.tasks.shutdown()
        tmp.cleanup()
        os.environ.clear()
        os.environ.update(saved)
        config.reset_config()
    return {"chunks": len(texts), "first_search_s": first_s, "segments_before": before[0],
            "segments_after_ingest": tier.n_segments, "ingest_s": ingest_s, "ingested_chunks": ingest["total_chunks"],
            "found_in_top5": True, "rebuilt_segments": rebuilt.n_segments, "same_object_after_ingest": True,
            "first_hit": first[0]["doc_id"] if first else None, "card": card_line()}


def phase_tiers(state: dict) -> None:
    """Phase 11: the capacity tiers at 3M x d1024 (phase 5's corpus,
    queries and oracle), one at a time, then INDEX_KIND=segmented behind
    the service."""
    import intool_rag_tpu_torch.index.ivf_index as ivf_mod
    import intool_rag_tpu_torch.index.ivf_residual as res_mod
    import intool_rag_tpu_torch.index.segmented_residual as seg_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(0)
    centers = _unit(gen, (CAP_NLIST, DIM), dev)  # phase 5's topic centres
    qs, q_sub, oracle = _capacity_queries(centers)
    builds = {
        "ivf bf16": (ivf_mod, False, lambda x, d: ivf_mod.IVFFlatIndex.build(x, TIER_NLIST, dtype=torch.bfloat16,
                                                                              device=d)),
        "ivf_residual int4": (res_mod, True, lambda x, d: res_mod.IVFResidualIndex.build(
            x, TIER_NLIST, refine=True, bits=4, device=d)),
        "ivf_residual int1": (res_mod, True, lambda x, d: res_mod.IVFResidualIndex.build(
            x, TIER_NLIST, refine=True, bits=1, device=d)),
    }
    results = {}
    with _NoKernelOrPlain("phase 11") as watch:
        corpus = _tier_corpus(centers)
        for name, (module, refine, build) in builds.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with _KmeansClock(module) as clock:
                index = build(corpus, dev)
                torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            card_b, host_b = _tier_bytes(index)
            results[name] = {
                "build_s": build_s, "kmeans_s": clock.seconds, "card_bytes_per_row": card_b / CAP_ROWS,
                "host_bytes_per_row": host_b / CAP_ROWS, "card_mb": card_b / 1e6, "host_mb": host_b / 1e6,
                "cap": index.cap, "overflow_len": index.overflow_len, **_gather_sizes(index.cap),
                "by_nprobe": _tier_search_runs(name, index, qs, q_sub, oracle, refine),
            }
            del index
            torch.cuda.empty_cache()
            results[name]["card_vs_cpu_max_err"] = _tier_card_vs_cpu(name, build, corpus, qs[0], module)
            log(f"phase 11 {name}: {json.dumps(results[name])}")
        # the streaming tier: k-means on the first segment, six appends, as benchmarks/bench_segmented.py
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _KmeansClock(seg_mod) as clock:
            index = seg_mod.SegmentedResidualIndex.train(corpus[:TIER_SEG_ROWS], TIER_NLIST, seg_rows=TIER_SEG_ROWS,
                                                         bits=1, refine=True, device=dev)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for start in range(0, CAP_ROWS, TIER_SEG_ROWS):
            index.append(corpus[start : start + TIER_SEG_ROWS])
        torch.cuda.synchronize()
        append_s = time.perf_counter() - t0
        card_b, host_b = _tier_bytes(index)
        name = "segmented int1"
        results[name] = {
            "build_s": train_s + append_s, "kmeans_s": clock.seconds, "append_rows_per_s": CAP_ROWS / append_s,
            "segments": index.n_segments, "store_capacity_segments": index._store[0].shape[0],
            "card_bytes_per_row": card_b / CAP_ROWS, "host_bytes_per_row": host_b / CAP_ROWS,
            "card_mb": card_b / 1e6, "host_mb": host_b / 1e6, "cap": index.cap, "max_overflow": index.max_overflow,
            **_gather_sizes(index.cap),
            "by_nprobe": _tier_search_runs(name, index, qs, q_sub, oracle, True),
        }
        centroids = index.centroids
        del index
        torch.cuda.empty_cache()
        results[name]["card_vs_cpu_max_err"] = _tier_card_vs_cpu(
            name, lambda x, d: _segmented_slice(seg_mod, centroids, x, d), corpus, qs[0], seg_mod)
        log(f"phase 11 {name}: {json.dumps(results[name])}")
        del corpus
        torch.cuda.empty_cache()
    low = {n: r["by_nprobe"][16]["recall@10"] for n, r in results.items() if r["by_nprobe"][16]["recall@10"] < 0.95}
    if low:
        raise AssertionError(f"phase 11: recall@10 at nprobe 16 below 0.95: {low}")
    service = _tier_service(state)
    log(f"phase 11 service, INDEX_KIND=segmented: {json.dumps(service)}")
    state["tiers"] = {"by_tier": results, "service": service, "launches": watch.launches, "card": card_line()}
    for row in state.get("kernels", []):
        row["launches_capacity_tiers"] = watch.launches.get(row["name"], 0)


def _segmented_slice(seg_mod, centroids: torch.Tensor, rows: torch.Tensor, device) -> object:
    """A segmented tier over ``rows`` with the given centroids (the card's
    run's), one segment."""
    index = seg_mod.SegmentedResidualIndex(centroids.to(device), seg_rows=TIER_SLICE, bits=1, refine=True,
                                           device=device)
    index.append(rows)
    return index


# ------------------------------------------------------------------ phase 12

LM_SEED, LM_BATCH, LM_SEQ, LM_STEPS, LM_LR = 12, 4, 512, 4, 1e-4
SPEC_CONFIG = dict(hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2, intermediate_size=128,
                   max_position=512, dtype="float32")
OCR_DIGIT_STEPS, OCR_REC_STEPS, OCR_DET_STEPS, OCR_CLS_STEPS = 250, 200, 20, 100


def _lm_full_width(state: dict, dev) -> dict:
    """``make_train_step`` at TinyLlama width (22 x 2048, f32 master
    weights, bf16 compute, seeded init, Adam): four steps on one fixed
    batch of the copy task; losses finite and falling."""
    from intool_rag_tpu_torch.models.decoder import DecoderConfig, DecoderLM
    from intool_rag_tpu_torch.models.lm_train import copy_task_batch, make_optimizer, make_train_step
    from intool_rag_tpu_torch.train.contrastive import TrainState

    cfg = DecoderConfig.tinyllama()
    torch.cuda.reset_peak_memory_stats()
    model = DecoderLM(cfg, device=dev, param_dtype=torch.float32).init_random(
        torch.Generator(device=dev).manual_seed(LM_SEED))
    state_ = TrainState(model, *make_optimizer(model, LM_LR))
    step = make_train_step(cfg, clip=1.0)
    batch = torch.as_tensor(copy_task_batch(np.random.default_rng(LM_SEED), LM_BATCH, LM_SEQ, cfg.vocab_size),
                            device=dev)
    losses, times = [], []
    for _ in range(LM_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(state_, batch)))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"phase 12: full-width losses {losses} are not finite and falling")
    step_ms = 1000 * float(np.mean(times[1:]))
    out = {"config": "TinyLlama 22 x 2048, 32 heads over 4, MLP 5632, vocab 32000, f32 master, bf16 compute",
           "batch": f"{LM_BATCH} x S {LM_SEQ}", "params": sum(p.numel() for p in model.parameters()),
           "losses": losses, "step_ms": step_ms, "step_ms_runs": [1000 * t for t in times],
           "tokens_per_s": LM_BATCH * LM_SEQ / (step_ms / 1000), "peak_mb": torch.cuda.max_memory_allocated() / 1e6,
           "card": card_line()}
    state["lm_profile"] = (lambda: step(state_, batch), out)
    return out


def lm_busy_share(state: dict) -> None:
    """The device's busy share of one full-width training step and its
    launches, from ``torch.profiler`` (after every other timing)."""
    fn, out = state.pop("lm_profile")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = 1000 * (time.perf_counter() - t0)
    kernels = _profiled_kernels(fn)
    busy = sum(ms for _, ms, _ in kernels)
    out["profile"] = ("not measured: torch.profiler reported no device time" if not kernels else
                      {"step_wall_ms": wall_ms, "device_busy_ms": busy, "device_busy_share": busy / wall_ms,
                       "launches_per_step": sum(c for _, _, c in kernels),
                       "top_kernels": [{"name": n[:48], "ms": ms, "calls": c}
                                       for n, ms, c in sorted(kernels, key=lambda k: -k[1])[:6]]})
    log(f"phase 12 one full-width step under torch.profiler: {json.dumps(out['profile'])}")


def _lm_card_vs_cpu(dev) -> dict:
    """One step's loss and gradients of a 2-layer f32 decoder, card against
    CPU: loss rtol 1e-5, gradient cosine >= 0.99999 per tensor."""
    from intool_rag_tpu_torch.models.decoder import DecoderConfig, DecoderLM
    from intool_rag_tpu_torch.models.lm_train import copy_task_batch, lm_loss

    cfg = DecoderConfig(vocab_size=256, hidden_size=256, num_layers=2, num_heads=8, num_kv_heads=2,
                        intermediate_size=512, max_position=256, dtype="float32")
    init = DecoderLM(cfg, device="cpu", param_dtype=torch.float32).init_random(torch.Generator().manual_seed(3))
    batch = torch.as_tensor(copy_task_batch(np.random.default_rng(3), 4, 128, cfg.vocab_size))
    grads, losses = [], []
    for d in (dev, torch.device("cpu")):
        model = DecoderLM(cfg, device=d, param_dtype=torch.float32)
        model.load_state_dict(init.state_dict())
        loss = lm_loss(model, batch.to(d))
        loss.backward()
        losses.append(float(loss.detach()))
        grads.append({n: p.grad.detach().cpu().double() for n, p in model.named_parameters()})
    cos = min(float(torch.nn.functional.cosine_similarity(grads[0][n].flatten(), grads[1][n].flatten(), dim=0))
              for n in grads[0] if grads[1][n].abs().max() > 0)
    rel = abs(losses[0] - losses[1]) / abs(losses[1])
    if rel > 1e-5 or cos < 0.99999:
        raise AssertionError(f"phase 12: card against CPU loss rel {rel}, min gradient cosine {cos}")
    return {"loss_card": losses[0], "loss_cpu": losses[1], "loss_rel_diff": rel, "min_grad_cosine": cos}


def _spec_acceptance(task: str, dev) -> dict:
    """The JAX scheduler's slow acceptance test on the card: train the
    2-layer model from the JAX test's initial weights, then plain waves
    against prompt-lookup waves (gamma 4, window 64) through
    ``ContinuousGenerator``; the JAX test's bars."""
    from intool_rag_tpu_torch.models.decoder import DecoderConfig
    from intool_rag_tpu_torch.models.lm_train import (
        copy_task_batch, rag_qa_prompts, spec_init, train_copy_lm, train_rag_qa_lm,
    )
    from intool_rag_tpu_torch.models.scheduler import ContinuousGenerator

    t0 = time.perf_counter()
    if task == "copy":
        cfg = DecoderConfig(vocab_size=64, **SPEC_CONFIG)
        model, losses = train_copy_lm(cfg, steps=700, batch=32, seq=48, seed=0, init_params=spec_init("copy"),
                                      device=dev)
        prompts = [row.tolist() for row in copy_task_batch(np.random.default_rng(42), 6, 40, cfg.vocab_size)]
        limits, slots, loss_bar, quote_bar, wave_bar = [24] * 6, 3, 0.35, 0.9, 2.0
    else:
        cfg = DecoderConfig(vocab_size=96, **SPEC_CONFIG)
        model, losses = train_rag_qa_lm(cfg, steps=800, batch=32, seq=56, seed=0, n_fields=3, val_len=7,
                                        init_params=spec_init("rag_qa"), device=dev)
        prompts, _ = rag_qa_prompts(np.random.default_rng(123), 8, 96, n_fields=3, val_len=7)
        limits, slots, loss_bar, quote_bar, wave_bar = [10] * 8, 4, 0.75, 0.8, 1.5
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want, _ = ContinuousGenerator(model, n_slots=slots, seg_len=4).generate_many(prompts, limits)
    plain_s = time.perf_counter() - t0
    quote = float(np.mean([np.isin(np.asarray(w), np.asarray(p)).mean() for w, p in zip(want, prompts)]))
    t0 = time.perf_counter()
    got, stats = ContinuousGenerator(model, n_slots=slots, seg_len=4, speculative_gamma=4,
                                     lookup_window=64).generate_many(prompts, limits)
    spec_s = time.perf_counter() - t0
    out = {"train_s": train_s, "train_step_ms": 1000 * train_s / len(losses), "first_loss": losses[0],
           "last_loss": losses[-1], "quote_rate": quote, "tokens_equal": got == want,
           "tokens_per_wave": stats["tokens_per_wave"], "plain_s": plain_s, "speculative_s": spec_s}
    if not (losses[-1] < loss_bar * losses[0] and quote >= quote_bar and got == want
            and stats["tokens_per_wave"] >= wave_bar):
        raise AssertionError(f"phase 12 {task}: below the JAX test's bars: {out}")
    return out


def _ocr_training(dev) -> dict:
    """The OCR trainers' step stages on the committed fixture."""
    from intool_rag_tpu_torch import config
    from intool_rag_tpu_torch.ocr import train as ocr_train
    from intool_rag_tpu_torch.ocr.models import DBDetector, OCRModelBundle, OrientationClassifier, make_recognizer
    from intool_rag_tpu_torch.ocr.postprocess import ctc_greedy_decode

    torch.backends.cudnn.allow_tf32 = False
    fx = ocr_train.load_train_fixture()
    out = {}

    def seeded(fn, seed=0):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            return fn().to(dev)

    # digits from scratch: the JAX digits test's 250 batches
    rec = seeded(lambda: make_recognizer("conv", 10, 32))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = ocr_train.recognizer_steps(rec, fx["digit_batches"][:OCR_DIGIT_STEPS], blank=10)
    digits_s = time.perf_counter() - t0
    images = np.repeat(fx["digit_test"][..., None] / np.float32(255.0), 3, axis=3)
    with torch.no_grad():
        decoded = ctc_greedy_decode(rec(torch.as_tensor(images, device=dev)).cpu().numpy(), ocr_train.DIGITS)
    correct = sum(got == want for (got, _), want in zip(decoded, ocr_train.DIGIT_TESTS))
    out["digits"] = {"steps": len(losses), "first_loss": losses[0], "last_loss": losses[-1], "read": correct,
                     "decoded": [t for t, _ in decoded], "step_ms": 1000 * digits_s / len(losses)}
    if not (losses[-1] < 0.2 * losses[0] and correct >= 2):
        raise AssertionError(f"phase 12 digits: below the JAX test's bars: {out['digits']}")
    # the cached recognizer's step stage from the shipped weights at their width
    bundle = OCRModelBundle.load(config.OCR_DEFAULT_WEIGHTS)
    rec = bundle.rec.to(dev)
    if bundle.charset != fx["charset"]:
        raise AssertionError("phase 12: the fixture's rec pool was labelled with another charset")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = ocr_train.recognizer_pool_steps(rec, fx["rec_images"], fx["rec_labels"], fx["rec_label_pad"],
                                             blank=len(bundle.charset), steps=OCR_REC_STEPS, batch=32,
                                             steps_per_launch=100)
    rec_s = time.perf_counter() - t0
    out["rec_cached"] = {"width": rec.width, "steps": len(losses), "first_loss": losses[0], "last_loss": losses[-1],
                         "mean_loss_first_20": float(np.mean(losses[:20])),
                         "mean_loss_last_20": float(np.mean(losses[-20:])), "step_ms": 1000 * rec_s / len(losses)}
    if not np.isfinite(losses).all():
        raise AssertionError(f"phase 12 cached rec: {out['rec_cached']}")
    # the detector at width 16 on the 16 pages: four batches of four, five rounds
    det = seeded(lambda: DBDetector(16))
    pages = np.repeat(fx["det_images"][..., None] / np.float32(255.0), 3, axis=3)
    batches = [(pages[i : i + 4], fx["det_maps"][i : i + 4]) for i in range(0, 16, 4)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = ocr_train.detector_steps(det, [batches[i % 4] for i in range(OCR_DET_STEPS)])
    det_s = time.perf_counter() - t0
    out["det"] = {"steps": len(losses), "losses": losses, "step_ms": 1000 * det_s / len(losses)}
    if not (np.isfinite(losses).all() and np.mean(losses[-4:]) < np.mean(losses[:4])):
        raise AssertionError(f"phase 12 detector: losses not finite and falling: {losses}")
    # the classifier's cached step stage (optax's schedule needs more steps than its 50 of warm-up)
    cls_model = seeded(lambda: OrientationClassifier(16))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = ocr_train.classifier_pool_steps(cls_model, fx["cls_images"], fx["cls_labels"], steps=OCR_CLS_STEPS,
                                             batch=64, steps_per_launch=50)
    cls_s = time.perf_counter() - t0
    out["cls_cached"] = {"steps": len(losses), "mean_loss_first_10": float(np.mean(losses[:10])),
                         "mean_loss_last_10": float(np.mean(losses[-10:])), "step_ms": 1000 * cls_s / len(losses)}
    if not np.isfinite(losses).all():
        raise AssertionError(f"phase 12 classifier: {out['cls_cached']}")
    return out


def phase_training(state: dict) -> None:
    """Phase 12: the decoder's and the OCR models' trainers on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    dev = torch.device(DEVICE)
    out = {}
    with _NoKernelOrPlain("phase 12") as watch:
        out["full_width"] = _lm_full_width(state, dev)
        log(f"phase 12 full width: {json.dumps(out['full_width'])}")
        out["card_vs_cpu"] = _lm_card_vs_cpu(dev)
        log(f"phase 12 card against CPU: {json.dumps(out['card_vs_cpu'])}")
        for task in ("copy", "rag_qa"):
            out[task] = _spec_acceptance(task, dev)
            log(f"phase 12 {task} model: {json.dumps(out[task])}")
        out["ocr"] = _ocr_training(dev)
        log(f"phase 12 OCR: {json.dumps(out['ocr'])}")
    out["launches"] = watch.launches
    out["card"] = card_line()
    state["training"] = out
    for row in state.get("kernels", []):
        row["launches_training"] = watch.launches.get(row["name"], 0)


# ------------------------------------------------------------------ phase 13

SHARDS = (1, 2, 4)  # the virtual meshes: S entries of the one card
HYBRID_SHARDS, HYBRID_BATCHES, HYBRID_CAP = 4, 8, 253_952  # 62 blocks of 4,096 rows a shard hold 1M rows
SMALL_ROWS, SMALL_CAP = 100_000, 28_672  # the DCN engine and the checkpoint: 7 blocks of 4,096 rows a shard
RARE_DF_SUM = 60  # a hybrid query's terms match at most this many chunks: its BM25 list has no tie at kc
QUERY_NOISE = 0.015  # per dim: a hybrid query embedding lies at cosine ~0.9 of its target chunk
SHARD_SEED = 13
KMEANS_ITERS = 8


class _KernelsNoPlain(_NoKernelOrPlain):
    """Over a block: every launch count set to 0 before and read after
    (``launches``), every plain version's calls counted; the block fails if
    a plain version ran. The kernels are expected."""

    def __exit__(self, *exc) -> None:
        for module, name, _, original in self.boxes:
            setattr(module, name, original)
        self.launches = _launches()
        self.plain_calls = sum(box["calls"] for _, _, box, _ in self.boxes) + sum(f.calls.count for f in self.flash)
        if exc[0] is None and self.plain_calls:
            raise AssertionError(f"{self.label}: plain versions called {self.plain_calls} times")


def _expect(watch: _KernelsNoPlain, want: dict, total: dict) -> None:
    """Each per-shard search of the block launched its kernel: the counts are
    exactly ``want`` (kernel variant -> shards x searches); add them to the
    phase's main-path ``total``."""
    if watch.launches != want:
        raise AssertionError(f"{watch.label}: launched {watch.launches}, expected {want} "
                             f"(one launch a shard a search)")
    for name, count in want.items():
        total[name] = total.get(name, 0) + count


def _held_equal(got, want, atol: float, gap: float, label: str) -> float:
    """Scores (sorted descending, [Q, k]) equal within ``atol`` position by
    position, and every row of ``want`` whose score lies more than ``gap``
    from every other score of its list (and from the k-th) in ``got`` too.
    Returns the largest score difference."""
    gv, gr, wv, wr = (t.cpu().numpy() for t in (*got, *want))
    err = float(np.abs(gv - wv).max()) if gv.size else 0.0
    if gv.shape != wv.shape or err > atol:
        raise AssertionError(f"{label}: scores {gv.shape} vs {wv.shape} differ by {err} > {atol}")
    for q, (v, a, b) in enumerate(zip(wv, gr, wr)):
        d = np.abs(v[:, None] - v[None, :]) + np.eye(len(v)) * 1e9
        clear = (d.min(axis=1) > gap) & (v - v[-1] > gap)
        missing = set(b[clear].tolist()) - set(a.tolist())
        if missing:
            raise AssertionError(f"{label}: query {q} lacks rows {missing} (got {a.tolist()}, want {b.tolist()})")
    return err


def _timed(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _batch_readings(search, merge_inputs: dict, dev) -> dict:
    """QPS of batches of ``Q_SCALE`` (three, each synchronised), the host
    side and the device time of a batch, the merge's device time and share,
    and the peak memory of one batch above what was allocated before it."""
    from intool_rag_tpu_torch.parallel.collectives import merge_topk

    runs = [Q_SCALE / _timed(search) for _ in range(3)]
    device_ms = cuda_ms(search, iters=5, warmup=1)
    host_ms, wall_ms = host_wall_ms(search, iters=5, warmup=1)
    merge_ms = cuda_ms(lambda: merge_topk(merge_inputs["vals"], merge_inputs["rows"], merge_inputs["k"], dev))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    search()
    torch.cuda.synchronize()
    return {"qps_mean": float(np.mean(runs)), "qps_runs": runs, "device_ms": device_ms, "host_ms": host_ms,
            "wall_ms": wall_ms, "merge_ms": merge_ms, "merge_share": merge_ms / device_ms,
            "peak_mb_above_resident": (torch.cuda.max_memory_allocated() - base) / 1e6}


def _capturing(merge_inputs: dict, dev):
    """A merge for :func:`sharded_search` that keeps its per-shard inputs."""
    from intool_rag_tpu_torch.parallel.collectives import merge_topk

    def merge(vals, rows, k):
        merge_inputs.update(vals=vals, rows=rows, k=k)
        return merge_topk(vals, rows, k, dev)

    return merge


def _shard_meshes(dev) -> list[tuple[str, int, object]]:
    """``(label, S, mesh)``: the virtual meshes of ``SHARDS`` entries of the
    one card, and, with two or more cards, the real mesh over all of them."""
    from intool_rag_tpu_torch.parallel.mesh import corpus_mesh, local_devices

    meshes = [(f"virtual S={s}", s, corpus_mesh([dev] * s)) for s in SHARDS]
    if torch.cuda.device_count() >= 2:
        devices = local_devices()
        meshes.append((f"real S={len(devices)}", len(devices), corpus_mesh(devices)))
    return meshes


def _sharded_flat(dev, corpus, planes, q, oracle, total: dict) -> dict:
    """(a) ``sharded_flat_topk`` (K1 bf16 precise) and
    ``sharded_flat_topk_int8`` (K2 int8r) over phase 4's store at each mesh."""
    from intool_rag_tpu_torch.ops.flat_fused import flat_topk_fused, flat_topk_fused_int8
    from intool_rag_tpu_torch.parallel.sharded_search import shard_corpus, sharded_flat_topk, sharded_flat_topk_int8

    n = N_SCALE
    c1, c2, cs = planes
    single = {  # the single-device search of the same store (group width 32, as the shards use)
        "K1 bf16 precise": lambda: flat_topk_fused(q, corpus, TOP_K, group_l=32, valid_n=n, precise=True, tail="exact"),
        "K2 int8r": lambda: flat_topk_fused_int8(q, c1, cs, TOP_K, corpus_res=c2, group_l=32, valid_n=n, tail="exact"),
    }
    want_single = {name: fn() for name, fn in single.items()}
    bars = {"K1 bf16 precise": (1e-4, 2e-4), "K2 int8r": (0.0, 0.0)}  # phase 2's bars: K1 1e-4, K2 bit-equal
    out = {}
    for label, s, mesh in _shard_meshes(dev):
        sh_bf = shard_corpus(corpus, mesh, row_align=4096)
        sh8 = [shard_corpus(p, mesh, row_align=4096) for p in (c1, cs, c2)]
        merge_inputs: dict = {}
        merge = _capturing(merge_inputs, dev)
        searches = {
            "K1 bf16 precise": lambda tail="fold": sharded_flat_topk(q, sh_bf, TOP_K, mesh, valid_n=n, kernel="fused",
                                                                     tail=tail, merge=merge),
            "K2 int8r": lambda tail="fold": sharded_flat_topk_int8(q, sh8[0], sh8[1], TOP_K, mesh, res=sh8[2],
                                                                   valid_n=n, tail=tail, merge=merge),
        }
        for name, search in searches.items():
            search()  # allocations
            with _KernelsNoPlain(f"phase 13 (a) {label} {name}") as watch:
                _, rows = search()
                times = [_timed(search) for _ in range(2)]
            _expect(watch, {name: 3 * s}, total)
            recall = _recall(rows[:ORACLE_Q].cpu().numpy(), oracle)
            if recall < 0.99:
                raise AssertionError(f"phase 13 (a) {label} {name}: recall@10 {recall} < 0.99 vs the exact oracle")
            err = _held_equal(search("exact"), want_single[name], *bars[name], f"phase 13 (a) {label} {name}")
            entry = {"mesh": label, "shards": s, "shard_rows": sh_bf.shard_rows, "recall@10": recall,
                     "max_abs_err_vs_single_device": err, "first_batch_ms": 1000 * times[0],
                     **_batch_readings(search, merge_inputs, dev)}
            out[f"{label} {name}"] = entry
            log(f"phase 13 (a) {label} {name}: {json.dumps(entry)}")
        del sh_bf, sh8, searches, merge_inputs
        torch.cuda.empty_cache()
    return out


def _split_plans(dev) -> dict:
    """K1 bf16 precise and K2 int8r on one shard of a 4-way sharded 1M-row
    store (62 blocks of 4,096 rows) at Q 256 and 128, under
    ``plan_launch``'s plan and under the plan its merge bound
    (``MAX_MERGE_ROWS``) rules out, in turns (bounded, unbounded, unbounded,
    bounded): device ms of each."""
    from intool_rag_tpu_torch.ops import flat_fused as ff
    from intool_rag_tpu_torch.ops.quant import quantize_int8_residual

    n = 253_952
    gen = torch.Generator(device=dev).manual_seed(SHARD_SEED + 2)
    c = _unit(gen, (n, DIM), dev).bfloat16()
    c1, c2, cs = quantize_int8_residual(c)
    bound, out = ff.MAX_MERGE_ROWS, {}
    for q in (256, 128):
        qs = _unit(gen, (q, DIM), dev)
        hi, lo = ff.split_query_bf16(qs)
        a1, a2, _ = ff.split_query_int8(qs)
        for name, fn in (("K1 bf16 precise", lambda: ff.partial_topk(hi, lo, c, 32, n)),
                         ("K2 int8r", lambda: ff.partial_topk_int8(a1, a2, c1, c2, cs, 32, n))):
            times: dict[str, list] = {"bounded": [], "unbounded": []}
            plans = {}
            for turn in ("bounded", "unbounded", "unbounded", "bounded"):
                ff.MAX_MERGE_ROWS = bound if turn == "bounded" else 1 << 30
                try:
                    plans[turn] = ff.plan_launch(q, n, DIM, 32, ff._sm_count(dev), name)
                    times[turn].append(cuda_ms(fn, iters=3, warmup=1))
                finally:
                    ff.MAX_MERGE_ROWS = bound
            out[f"{name} Q {q}"] = {f"{t}_plan": plans[t] for t in plans} | {
                f"{t}_ms": float(np.mean(v)) for t, v in times.items()}
    log(f"phase 13 (a) split plans at a 4-way shard (62 blocks): {json.dumps(out)}")
    return out


def _zipf_terms(n: int) -> np.ndarray:
    """Phase 4's chunk terms ``[n, TERMS_PER_CHUNK]`` (``make_sparse``'s first draw)."""
    return (np.random.default_rng(0).zipf(1.2, size=(n, TERMS_PER_CHUNK)) - 1) % VOCAB


def _hybrid_queries(chunk_terms: np.ndarray, corpus32: torch.Tensor, gen) -> tuple[list[str], torch.Tensor, np.ndarray]:
    """``Q_SCALE`` hybrid queries, each aimed at a target chunk: its rarest
    terms (together in at most ``RARE_DF_SUM`` chunks, so no BM25 list ties
    at its cut and ``p_max`` prunes none of them) and its embedding at
    cosine ~0.9. Returns ``(texts, embeddings, targets)``."""
    st = np.sort(chunk_terms, axis=1)
    first = np.ones_like(st, dtype=bool)
    first[:, 1:] = st[:, 1:] != st[:, :-1]
    df = np.bincount(st[first], minlength=VOCAB)
    rng = np.random.default_rng(SHARD_SEED)
    targets = rng.choice(len(chunk_terms), size=Q_SCALE, replace=False)
    texts = []
    for t in targets:
        terms = np.unique(chunk_terms[t])
        picked, used = [], 0
        for term in terms[np.argsort(df[terms], kind="stable")][:3]:
            if picked and used + df[term] > RARE_DF_SUM:
                break
            picked.append(term)
            used += df[term]
        texts.append(" ".join(f"term{x}" for x in picked))
    rows = corpus32[torch.as_tensor(targets, device=corpus32.device)]
    q = rows + QUERY_NOISE * torch.randn(rows.shape, generator=gen, device=rows.device)
    return texts, q / q.norm(dim=1, keepdim=True), targets


def _single_bm25(engine, row_of_gid: np.ndarray, n: int, dev):
    """The single-device ``BM25Index`` of the sharded engine's documents, in
    row order, from its counted postings (the texts are tokenized once)."""
    from intool_rag_tpu_torch.index.bm25_index import BM25Index

    bm = engine.bm25
    words = list(bm.vocab)  # first-seen order
    order = sorted(range(len(words)), key=words.__getitem__)
    rank = np.empty(len(words), np.int32)
    rank[order] = np.arange(len(words), dtype=np.int32)
    rows = np.concatenate([row_of_gid[sc.slots.astype(np.int64) * bm.n_shards + s] for s, sc in enumerate(bm.shards)])
    sizes = np.concatenate([np.diff(sc.indptr) for sc in bm.shards])
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    terms = np.concatenate([sc.terms for sc in bm.shards])
    counts = np.concatenate([sc.counts for sc in bm.shards])
    lens = np.concatenate([sc.lens for sc in bm.shards])
    by_row = np.argsort(rows, kind="stable")
    sz = sizes[by_row]
    pairs = np.repeat(starts[by_row] - np.concatenate([[0], np.cumsum(sz)[:-1]]), sz) + np.arange(int(sz.sum()))
    pair_terms = rank[terms[pairs]]
    counted = ([words[i] for i in order], np.bincount(pair_terms, minlength=len(words)).astype(np.int32),
               np.concatenate([[0], np.cumsum(sz)]).astype(np.int64), pair_terms, counts[pairs], lens[by_row])
    return BM25Index._from_counts(counted, n, bm.params, dev)


def _with_env(env: dict):
    from intool_rag_tpu_torch import config

    os.environ.update(env)
    config.reset_config()
    return config.get_config()


def _sharded_hybrid(dev, corpus32, texts, chunk_terms, gen, total: dict) -> dict:
    """(b) ``ShardedHybrid`` (int8r) over phase 4's million rows and Zipf
    chunks, appended in ``HYBRID_BATCHES``: weighted and RRF fusion against
    the exact hybrid oracle and the single-device hybrid."""
    from intool_rag_tpu_torch.index.bm25_index import BM25Params, bm25_dispatch
    from intool_rag_tpu_torch.index.hybrid import _fuse
    from intool_rag_tpu_torch.ops.bm25 import bm25_topk_sorted
    from intool_rag_tpu_torch.ops.flat_fused import flat_topk_fused_int8
    from intool_rag_tpu_torch.ops.quant import quantize_int8_residual
    from intool_rag_tpu_torch.ops.topk import flat_topk
    from intool_rag_tpu_torch.parallel.mesh import corpus_mesh
    from intool_rag_tpu_torch.parallel.sharded_hybrid import ShardedHybrid

    n = N_SCALE
    q_texts, q_emb, targets = _hybrid_queries(chunk_terms, corpus32[:n], gen)
    mesh = corpus_mesh([dev] * HYBRID_SHARDS)
    engine = ShardedHybrid(DIM, mesh, capacity_per_shard=HYBRID_CAP, params=BM25Params(p_max=P_MAX), quant="int8r")
    step = n // HYBRID_BATCHES
    t0 = time.perf_counter()
    gids = np.concatenate([engine.append(texts[b : b + step], corpus32[b : b + step]) for b in range(0, n, step)])
    torch.cuda.synchronize()
    append_s = time.perf_counter() - t0
    if engine.corpus.cap != HYBRID_CAP or engine.valid_n != n:
        raise AssertionError(f"phase 13 (b): cap {engine.corpus.cap}, {engine.valid_n} rows")
    row_of_gid = np.full(HYBRID_SHARDS * HYBRID_CAP, -1, np.int64)
    row_of_gid[gids] = np.arange(n)
    to_rows = torch.as_tensor(row_of_gid, device=dev)
    t0 = time.perf_counter()
    engine.bm25.device_arrays()
    torch.cuda.synchronize()
    postings_s = time.perf_counter() - t0

    # the single-device hybrid of the same rows: K2 int8r over the same codes
    # (quantized as the sharded corpus quantizes), BM25Index of the same counts
    single_planes = quantize_int8_residual(corpus32, reciprocal=True)
    t0 = time.perf_counter()
    index = _single_bm25(engine, row_of_gid, n, dev)
    single_bm25_s = time.perf_counter() - t0
    qt, qf, b_arrays, b_statics = index.topk_plan(q_texts)

    def single_hybrid(cfg):
        q1, q2, s8 = single_planes
        d_vals, d_rows = flat_topk_fused_int8(q_emb, q1, s8, CANDIDATES, corpus_res=q2, group_l=1, valid_n=n,
                                              tail="exact")
        s_vals, s_rows = bm25_dispatch(qt, qf, b_arrays, k=CANDIDATES, **b_statics)
        return _fuse(d_vals, d_rows, s_vals, s_rows, TOP_K, fusion_mode=cfg.FUSION_MODE, rrf_k=cfg.RRF_K,
                     w_dense=cfg.VECTOR_WEIGHT, w_sparse=cfg.BM25_WEIGHT)

    # the exact hybrid oracle (phase 4's construction): exact f32 dense top-100
    # of the appended rows, exact BM25 (no query term is pruned), the same fusion
    qo = q_emb[:ORACLE_Q]
    od_vals, od_rows = flat_topk(qo, corpus32, CANDIDATES, metric="ip", block_n=100_000, valid_n=n)
    os_vals, os_rows = bm25_topk_sorted(qt[:ORACLE_Q], qf[:ORACLE_Q], index.term_start, index.term_len, index.post_docs,
                                        index.post_w, index.idf, CANDIDATES, n_docs=n, p_max=P_MAX)

    out = {"rows": n, "shards": HYBRID_SHARDS, "mesh": f"virtual S={HYBRID_SHARDS}", "append_s": append_s,
           "append_rows_per_s": n / append_s, "postings_build_s": postings_s, "single_bm25_from_counts_s": single_bm25_s,
           "card_mb": sum(t.numel() * t.element_size() for p in engine.corpus._planes() for t in p.shards) / 1e6}
    def rows_of(gids: torch.Tensor) -> torch.Tensor:
        return to_rows[gids.clamp_min(0).long()].masked_fill(gids < 0, -1)

    # each retriever's list of the sharded engine (both at group width 1 and
    # the exact tail) against the single-device one's: the dense lists equal
    # (the same codes, K2 bit-equal), BM25 to 1e-5 of its largest score (f32
    # sums in the order of each package's term ids) with rows wherever no
    # score ties (equal tf at equal lengths ties: the chunks are 64 tokens)
    q1, q2, s8 = single_planes
    lists = {
        "dense": (engine.corpus.search(q_emb, CANDIDATES, group_l=1, tail="exact"),
                  flat_topk_fused_int8(q_emb, q1, s8, CANDIDATES, corpus_res=q2, group_l=1, valid_n=n, tail="exact"),
                  0.0),
        "bm25": (engine.bm25.topk(q_texts, CANDIDATES), bm25_dispatch(qt, qf, b_arrays, k=CANDIDATES, **b_statics),
                 1e-5),
    }
    for name, ((gv, gg), (wv, wr), tol) in lists.items():
        wr = torch.where(wv > 0, wr, -1) if name == "bm25" else wr  # the single index's no-match slots: (0.0, 0)
        bar = tol * float(wv.abs().max())
        out[f"{name}_list_max_abs_err"] = _held_equal((gv, rows_of(gg)), (wv, wr), bar, bar,
                                                      f"phase 13 (b) the {name} list vs the single-device index")
    saved = dict(os.environ)
    try:
        for mode in ("weighted", "rrf"):
            cfg = _with_env({"FUSION_MODE": mode, "HYBRID_SEARCH_ENABLED": "true"})
            search = lambda: engine.search(q_texts, q_emb, TOP_K, candidates=CANDIDATES)  # noqa: E731
            search()
            with _KernelsNoPlain(f"phase 13 (b) {mode}") as watch:
                _, got = search()
                times = [_timed(search) for _ in range(2)]
            _expect(watch, {"K2 int8r": 3 * HYBRID_SHARDS}, total)
            got = rows_of(got).cpu().numpy()
            o_vals, oracle = _fuse(od_vals, od_rows, os_vals, os_rows, TOP_K, fusion_mode=mode, rrf_k=cfg.RRF_K,
                                   w_dense=cfg.VECTOR_WEIGHT, w_sparse=cfg.BM25_WEIGHT)
            # BM25-only chunks of one query term score alike (d = 0, equal s):
            # the oracle rows tied with its k-th fused score (within the int8r
            # error, 1e-4) are the cut's tie group, which any member fills
            recall = _tie_recall(got[:ORACLE_Q], o_vals.cpu().numpy(), oracle.cpu().numpy(), 1e-4)
            # the single-device hybrid over the same codes and counts, both at
            # group width 1 and the exact tail
            exact_vals, exact_rows = engine.search(q_texts, q_emb, TOP_K, candidates=CANDIDATES, group_l=1,
                                                   tail="exact")
            exact_rows = rows_of(exact_rows)
            single = single_hybrid(cfg)
            entry = {"recall@10_vs_exact_oracle": recall,
                     "recall@10_as_sets": _recall(got[:ORACLE_Q], oracle.cpu().numpy()),
                     "equal_sets_share": float(np.mean([set(a) == set(b) for a, b in zip(
                         exact_rows.tolist(), single[1].tolist())])),
                     "overlap@10_vs_single_device": _recall(exact_rows.cpu().numpy(), single[1].cpu().numpy()),
                     "top1_is_target": float(np.mean(got[:, 0] == targets)), "first_batch_ms": 1000 * times[0],
                     "qps_runs": [Q_SCALE / t for t in times]}
            out[mode] = entry
            if mode == "weighted":
                # fused scores position by position, rows wherever no score ties
                entry["max_abs_err_vs_single_device"] = _held_equal(
                    (exact_vals, exact_rows), single, 1e-6, 1e-6, "phase 13 (b) weighted vs the single-device hybrid")
            if mode == "weighted" and recall < 0.99:
                raise AssertionError(f"phase 13 (b) weighted: recall@10 {recall} < 0.99 against the exact hybrid oracle")
            if mode == "rrf":
                # RRF ranks BM25 ties (equal tf at equal lengths) in id order, which
                # the shards change, and ties a dense rank with the same BM25 rank:
                # its fused lists are held as the fusion of the sharded engine's own
                # retriever lists (each held above against the single-device one),
                # scores position by position, rows wherever no score ties
                (dv, dg), (sv, sg) = lists["dense"][0], lists["bm25"][0]
                want = _fuse(dv, rows_of(dg), sv, rows_of(sg), TOP_K, fusion_mode="rrf", rrf_k=cfg.RRF_K,
                             w_dense=cfg.VECTOR_WEIGHT, w_sparse=cfg.BM25_WEIGHT)
                entry["max_abs_err_vs_fused_lists"] = _held_equal((exact_vals, exact_rows), want, 0.0, 1e-9,
                                                                  "phase 13 (b) rrf vs its lists' fusion")
                if entry["top1_is_target"] < 0.95:
                    raise AssertionError(f"phase 13 (b) rrf: the target first in {entry['top1_is_target']} < 0.95")
            log(f"phase 13 (b) {mode}: {json.dumps(entry)}")
        cfg = _with_env({"FUSION_MODE": "weighted"})
        out["weighted_batch"] = _batch_readings(lambda: engine.search(q_texts, q_emb, TOP_K, candidates=CANDIDATES),
                                                _hybrid_merge_inputs(engine, q_emb), dev)
        log(f"phase 13 (b) build and batch (merge: the dense side's): "
            f"{json.dumps({k: v for k, v in out.items() if k not in ('weighted', 'rrf')})}")
    finally:
        os.environ.clear()
        os.environ.update(saved)
    del engine, index, single_planes
    torch.cuda.empty_cache()
    return out


def _tie_recall(got: np.ndarray, oracle_vals: np.ndarray, oracle: np.ndarray, gap: float) -> float:
    """Recall@k against an oracle whose k-th score may tie with scores past
    the cut: an oracle row counts as found when ``got`` holds it or its
    score lies within ``gap`` of the oracle's k-th (a member of the cut's tie
    group, which any member fills)."""
    hits = 0
    for g, v, o in zip(got, oracle_vals, oracle):
        have = set(g.tolist())
        hits += sum(1 for val, r in zip(v, o) if r in have or val - v[-1] <= gap)
    return hits / oracle.size


def _hybrid_merge_inputs(engine, q_emb) -> dict:
    """The dense side's per-shard candidate lists of one batch (the merge's inputs)."""
    from intool_rag_tpu_torch.parallel.sharded_search import sharded_flat_topk_int8

    box: dict = {}
    c = engine.corpus
    sharded_flat_topk_int8(q_emb, c.codes, c.scales, CANDIDATES, c.mesh, res=c.res, valid_n=c.counts,
                           merge=_capturing(box, c.mesh.out_device))
    return box


def _small_engines(dev, corpus32, texts, tmp: Path, total: dict) -> dict:
    """(d) ``DCNHybrid`` on a 2 x 2 mesh against ``ShardedHybrid`` on 4
    shards over the first ``SMALL_ROWS`` rows, and (b)'s checkpoint round
    trip of that ``ShardedHybrid``."""
    from intool_rag_tpu_torch.index.bm25_index import BM25Params
    from intool_rag_tpu_torch.parallel.dcn import DCNHybrid, dcn_mesh
    from intool_rag_tpu_torch.parallel.mesh import corpus_mesh
    from intool_rag_tpu_torch.parallel.sharded_hybrid import ShardedHybrid

    rows, texts = corpus32[:SMALL_ROWS], texts[:SMALL_ROWS]
    gen = torch.Generator(device=dev).manual_seed(SHARD_SEED + 1)
    q_texts = texts[:Q_SCALE]
    q_emb = rows[:Q_SCALE] + QUERY_NOISE * torch.randn((Q_SCALE, DIM), generator=gen, device=dev)
    kw = dict(capacity_per_shard=SMALL_CAP, params=BM25Params(p_max=P_MAX), quant="int8r")
    flat = ShardedHybrid(DIM, corpus_mesh([dev] * 4), **kw)
    dcn = DCNHybrid(DIM, dcn_mesh([dev] * 4, n_dcn=2), **kw)
    g1, g2 = flat.append(texts, rows), dcn.append(texts, rows)
    if not np.array_equal(g1, g2):
        raise AssertionError("phase 13 (d): the DCN engine placed rows elsewhere")
    out = {}
    saved = dict(os.environ)
    try:
        _with_env({"FUSION_MODE": "weighted", "HYBRID_SEARCH_ENABLED": "true"})
        results = {}
        for label, engine in (("ShardedHybrid S=4", flat), ("DCNHybrid 2x2", dcn)):
            engine.search(q_texts, q_emb, TOP_K, candidates=CANDIDATES)
            with _KernelsNoPlain(f"phase 13 (d) {label}") as watch:
                results[label] = engine.search(q_texts, q_emb, TOP_K, candidates=CANDIDATES)
                t = _timed(lambda: engine.search(q_texts, q_emb, TOP_K, candidates=CANDIDATES))
            _expect(watch, {"K2 int8r": 2 * 4}, total)
            out[label] = {"ms_per_batch": 1000 * t}
        (fv, fr), (dv, dr) = results.values()
        if not (torch.equal(fv, dv) and torch.equal(fr, dr)):
            raise AssertionError("phase 13 (d): DCNHybrid 2x2 differs from ShardedHybrid on 4 shards")
        if float((fr[:, 0].cpu() == torch.as_tensor(g1[:Q_SCALE])).float().mean()) < 0.99:
            raise AssertionError("phase 13 (d): the queried chunks are not first")
        t0 = time.perf_counter()
        flat.save(tmp / "sharded_hybrid")
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = ShardedHybrid.load(tmp / "sharded_hybrid", flat.mesh)
        load_s = time.perf_counter() - t0
        bv, br = back.search(q_texts, q_emb, TOP_K, candidates=CANDIDATES)
        if not (torch.equal(bv, fv) and torch.equal(br, fr)):
            raise AssertionError("phase 13 (b): the reloaded ShardedHybrid's results differ")
        files = sum(p.stat().st_size for p in (tmp / "sharded_hybrid").iterdir())
        out["checkpoint"] = {"rows": SMALL_ROWS, "save_s": save_s, "load_s": load_s, "files_mb": files / 1e6,
                             "bit_equal_after_reload": True}
    finally:
        os.environ.clear()
        os.environ.update(saved)
    log(f"phase 13 (d) and the checkpoint: {json.dumps(out)}")
    return out


def _sharded_bits(dev, centers, total: dict) -> dict:
    """(c) ``ShardedBitsIndex`` over phase 5's 3M x d1024 corpus at nlist
    256, against the single-device ``IVFBitsIndex`` from the same centroids
    and capacity."""
    from intool_rag_tpu_torch.index.bits_index import IVFBitsIndex
    from intool_rag_tpu_torch.parallel.mesh import corpus_mesh
    from intool_rag_tpu_torch.parallel.sharded_bits import ShardedBitsIndex

    capacity = CAP_NLIST * 4 * 4 * CAP_BLOCK_N  # 16 blocks a list: 4 a shard, and the same lists on one device
    trained = IVFBitsIndex.train(micro_chunk(1, centers, CAP_CHUNK), CAP_NLIST, capacity=capacity,
                                 block_n=CAP_BLOCK_N, iters=CAP_KMEANS_ITERS, refine=False, device=dev)
    sharded = ShardedBitsIndex(trained.centroids, corpus_mesh([dev] * 4), capacity=capacity, block_n=CAP_BLOCK_N)
    t0 = time.perf_counter()
    for c in range(CAP_ROWS // CAP_CHUNK):
        chunk = micro_chunk(1 + c, centers, CAP_CHUNK)
        if not np.array_equal(sharded.append(chunk), trained.append(chunk)):
            raise AssertionError("phase 13 (c): global row ids differ")
    torch.cuda.synchronize()
    both_s = time.perf_counter() - t0
    if sharded.cap_l != trained.cap_l or not np.array_equal(sharded.fill.sum(axis=1), trained.fill):
        raise AssertionError("phase 13 (c): the lists' populations differ from the single-device index")
    qs, q_sub, oracle = _capacity_queries(centers)
    search = lambda: sharded.search(qs[0], CAP_POOL, nprobe=16, group_l=CAP_GROUP)  # noqa: E731
    search()
    with _KernelsNoPlain("phase 13 (c)") as watch:
        _, pool = sharded.search(q_sub, CAP_POOL, nprobe=16, group_l=CAP_GROUP)
        _, top = sharded.search(q_sub, TOP_K, nprobe=16, group_l=CAP_GROUP)
        times = [_timed(search) for _ in range(3)]
    _expect(watch, {"K3": 5 * 4}, total)
    pool_recall, recall = _recall(pool.cpu().numpy(), oracle), _recall(top.cpu().numpy(), oracle)
    if pool_recall < 0.95:
        raise AssertionError(f"phase 13 (c): recall@10 in the pool of 100 at nprobe 16 {pool_recall} < 0.95")
    # equality: both at group width 1 and the exact tail (every probed slot a candidate)
    exact = dict(nprobe=16, group_l=1, tail="exact")
    err = _held_equal(sharded.search(q_sub, TOP_K, **exact), trained.search(q_sub, TOP_K, **exact), 1e-5, 1e-5,
                      "phase 13 (c) vs the single-device index")
    out = {"rows": sharded.total_rows, "mesh": "virtual S=4", "nlist": sharded.nlist, "cap_l": sharded.cap_l,
           "blocks_per_list_per_shard": sharded.local_blocks, "append_both_s": both_s,
           "bytes_per_shard_mb": sharded.bytes_per_shard / 1e6, "recall@10_in_pool@100": pool_recall,
           "recall@10_no_refine": recall, "max_abs_err_vs_single_device": err,
           "qps_runs": [Q_SCALE / t for t in times], "qps_mean": float(np.mean([Q_SCALE / t for t in times]))}
    log(f"phase 13 (c): {json.dumps(out)}")
    del sharded, trained
    torch.cuda.empty_cache()
    return out


def _sharded_kmeans_check(dev, centers) -> dict:
    """(e) ``sharded_kmeans`` (S=4) and ``hierarchical_kmeans`` (2 x 2) from
    the same initial centroids as single-device Lloyd steps
    (``ops/kmeans.py``), on phase 5's first chunk at nlist 256."""
    from intool_rag_tpu_torch.ops.kmeans import _kmeans_pp_init, lloyd_step_blockwise
    from intool_rag_tpu_torch.parallel.dcn import dcn_mesh, hierarchical_kmeans
    from intool_rag_tpu_torch.parallel.mesh import corpus_mesh
    from intool_rag_tpu_torch.parallel.sharded_kmeans import sharded_kmeans
    from intool_rag_tpu_torch.parallel.sharded_search import shard_corpus

    points = micro_chunk(1, centers, CAP_CHUNK)
    init = _kmeans_pp_init(points[:4096], CAP_NLIST, 0)
    t0 = time.perf_counter()
    c = init
    for _ in range(KMEANS_ITERS):
        assign, sums, counts = lloyd_step_blockwise(points, c)
        c = torch.where((counts < 0.5)[:, None], c, sums / counts[:, None].clamp_min(1.0))
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    out = {"points": CAP_CHUNK, "k": CAP_NLIST, "iters": KMEANS_ITERS, "single_device_s": single_s}
    for label, mesh, fn in (("sharded_kmeans S=4", corpus_mesh([dev] * 4), sharded_kmeans),
                            ("hierarchical_kmeans 2x2", dcn_mesh([dev] * 4, n_dcn=2), hierarchical_kmeans)):
        pts = shard_corpus(points, mesh)
        t0 = time.perf_counter()
        got, got_assign = fn(pts, CAP_NLIST, mesh, valid_n=CAP_CHUNK, iters=KMEANS_ITERS, init=init)
        torch.cuda.synchronize()
        err = float((got - c).abs().max())
        same = float((got_assign.gather()[:CAP_CHUNK] == assign).float().mean())
        if err > 1e-4:
            raise AssertionError(f"phase 13 (e) {label}: centroids differ by {err} > 1e-4")
        out[label] = {"s": time.perf_counter() - t0, "max_abs_err": err, "same_assignment_share": same}
    log(f"phase 13 (e): {json.dumps(out)}")
    return out


def _service_sharded_on(state: dict, total: dict) -> dict:
    """(f) ``SHARDED_SEARCH=on`` behind the HTTP service on one card: the
    single-device route (as the JAX package on one chip), the answers of
    ``off``, K1 launched."""
    from intool_rag_tpu_torch import config
    from intool_rag_tpu_torch.providers.cuda_embed import CudaEmbeddingProvider
    from intool_rag_tpu_torch.service.app import RAGService
    from intool_rag_tpu_torch.service.http import ServiceServer

    rng = np.random.default_rng(SHARD_SEED)
    vocab, texts = _word_corpus(np.random.default_rng(1))
    texts = texts[: TIER_SERVICE_DOCS * CHUNKS_PER_DOC]
    questions = [texts[i] for i in rng.choice(len(texts), size=N_REQUESTS // 2, replace=False)]
    questions += [" ".join(rng.choice(vocab[:2000], size=4)) for _ in range(N_REQUESTS // 2)]
    saved = dict(os.environ)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_sharded_")
    answers, out = {}, {"devices": torch.cuda.device_count(), "chunks": len(texts)}
    try:
        _with_env({"STORAGE_DIR": tmp.name, "CACHE_DIR": os.path.join(tmp.name, "cache"), "INDEX_KIND": "flat",
                   "INDEX_DTYPE": "bfloat16", "DENSE_INT8": "0", "DENSE_INT8_RESIDUAL": "0", "USE_PALLAS": "1",
                   "EMBEDDING_QUERY_INSTRUCTION": ""})
        provider = CudaEmbeddingProvider(checkpoint=str(ENCODER_MID), device=DEVICE)
        _write_storage(Path(tmp.name), texts, provider, n_docs=TIER_SERVICE_DOCS)
        for mode in ("off", "on"):
            _with_env({"SHARDED_SEARCH": mode, "CACHE_DIR": os.path.join(tmp.name, f"cache_{mode}")})
            service = RAGService(provider, device=DEVICE)
            server = ServiceServer(service, host="127.0.0.1", port=0)
            server.start_background()
            try:
                _post(server.port, "warm up the search path")
                # one request at a time: each is a batch of its own in both runs
                # (the batcher's grouping of concurrent requests moves BM25's
                # summation order, and so the last digit of a score)
                with _KernelsNoPlain(f"phase 13 (f) SHARDED_SEARCH={mode}") as watch:
                    results = [_post(server.port, q) for q in questions]
            finally:
                server.shutdown()
                service.tasks.shutdown()
            dense = service.registry.engine.dense
            shards = mode == "on" and torch.cuda.device_count() >= 2  # JAX _use_sharded: two or more devices
            if (dense._sharded is not None) != shards or dense.routes_flat() == shards or \
                    set(watch.launches) != {"K1 bf16 precise"}:
                raise AssertionError(f"phase 13 (f) {mode}: launched {watch.launches}, sharded "
                                     f"{dense._sharded is not None}; expected the {'sharded' if shards else 'single-device'} "
                                     "route through K1")
            for name, count in watch.launches.items():
                total[name] = total.get(name, 0) + count
            answers[mode] = [[(h["doc_id"], h["chunk_id"], round(h["score"], 6)) for h in body["hits"]]
                             for _, body in results]
            out[mode] = {"p50_ms": 1000 * float(np.median([t for t, _ in results])), "launches": watch.launches}
    finally:
        tmp.cleanup()
        os.environ.clear()
        os.environ.update(saved)
        config.reset_config()
    same = answers["on"] == answers["off"] if out["devices"] == 1 else \
        [a[:1] for a in answers["on"]] == [a[:1] for a in answers["off"]]
    if not same:
        q = next(i for i, (a, b) in enumerate(zip(answers["on"], answers["off"])) if a != b)
        raise AssertionError(f"phase 13 (f): SHARDED_SEARCH=on answered otherwise than off: question {q}: "
                             f"{answers['on'][q]} vs {answers['off'][q]}")
    out["equal_answers"] = True
    log(f"phase 13 (f): {json.dumps(out)}")
    return out


def phase_sharded(state: dict) -> None:
    """Phase 13: corpus sharding on the card (``parallel/``), on virtual
    meshes of the one card (and on every card where there are two or more)."""
    from intool_rag_tpu_torch.ops.quant import quantize_int8_residual

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    dev = torch.device(DEVICE)
    log(f"phase 13: {torch.cuda.device_count()} CUDA device(s); the virtual meshes put S shards on {dev}, "
        "one after another, so their QPS at S > 1 forecasts nothing about S cards")
    total: dict[str, int] = {}
    results = {"devices": torch.cuda.device_count(), "card": card_line()}
    with _KernelsNoPlain("phase 13"), tempfile.TemporaryDirectory(prefix="chip_smoke_shards_") as tmp:
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(7)  # phase 4's corpus
        n_pad = -(-N_SCALE // 4096) * 4096
        corpus32 = torch.randn((n_pad, DIM), generator=gen, device=dev)
        corpus32 /= corpus32.norm(dim=1, keepdim=True)
        corpus = corpus32.bfloat16()
        planes = quantize_int8_residual(corpus)
        qgen = torch.Generator(device=dev).manual_seed(SHARD_SEED)
        q = _unit(qgen, (Q_SCALE, DIM), dev)
        _, oracle = _exact_dense(q[:ORACLE_Q], corpus)
        results["sharded_flat"] = _sharded_flat(dev, corpus, planes, q, oracle, total)
        del corpus, planes
        results["split_plans"] = _split_plans(dev)
        torch.cuda.empty_cache()
        chunk_terms = _zipf_terms(N_SCALE)
        words = np.array([f"term{t}" for t in range(VOCAB)], dtype=object)
        texts = [" ".join(row) for row in words[chunk_terms]]
        log(f"phase 13: corpus and {len(texts):,} chunk texts made in {time.perf_counter() - t0:.1f} s")
        results["sharded_hybrid"] = _sharded_hybrid(dev, corpus32, texts, chunk_terms, qgen, total)
        results["dcn_and_checkpoint"] = _small_engines(dev, corpus32, texts, Path(tmp), total)
        del corpus32, texts, chunk_terms
        torch.cuda.empty_cache()
        centers = _unit(torch.Generator(device=dev).manual_seed(0), (CAP_NLIST, DIM), dev)  # phase 5's
        results["sharded_bits"] = _sharded_bits(dev, centers, total)
        results["kmeans"] = _sharded_kmeans_check(dev, centers)
        results["service"] = _service_sharded_on(state, total)
    results["launches"] = total
    state["sharded"] = results
    for row in state.get("kernels", []):
        row["launches_sharded"] = total.get(row["name"], 0)
    log(f"phase 13 main-path launches: {json.dumps(total)}")


def _exact_dense(q: torch.Tensor, stored: torch.Tensor):
    """Phase 4's dense oracle of the stored rows: the blocked scan's top
    ``CANDIDATES``, rescored exactly in f32, its top ``TOP_K``."""
    from intool_rag_tpu_torch.ops.topk import flat_topk, rescore_candidates, top_k

    _, rows = flat_topk(q, stored, CANDIDATES, metric="ip", block_n=100_000, valid_n=N_SCALE)
    vals, pos = top_k(rescore_candidates(q, stored, rows, metric="ip"), TOP_K)
    return vals, torch.gather(rows, 1, pos).cpu().numpy()


# ------------------------------------------------------------------ phase 14

MP_SEED = 14
TP_DEGREES = (2, 4)  # tensor-parallel degrees, on virtual meshes of the one card
TP_PROMPTS, TP_PROMPT_LEN, TP_NEW = 2, 128, 32
TP_SCHED = (4, 2, 16)  # ContinuousGenerator: prompts, slots, new tokens each
TP_TIMED_STEPS, TP_PROFILED_STEPS = 32, 4  # decode steps behind ms a token, and behind launches a token
SP_SHARDS, SP_LEN, SP_VALID = (2, 4), 8192, 8000  # BGE-M3's long input, a padded tail
SP_F32_ATOL = 1e-4
MP_STEPS, MP_LOSS_REL, MP_F32_RTOL = 3, 1e-2, 1e-5
# the sharded bf16 gradient's distance to the f32 one, leaf by leaf, over one device's bf16 distance:
# 1.63 at worst and 1.016 over all leaves at bge_m3 width on an H100 (PERF.md, Findings)
MP_GRAD_RATIO = 2.5
TINYLLAMA_WIDTH = (22, 32, 4, 5632, 32000)  # layers, heads, kv heads, intermediate, vocabulary


def _meshes_of(make, sizes, dev) -> list[tuple[str, object]]:
    """``(label, mesh)``: ``make(devices)`` over ``n`` entries of the one card
    for each size, and over every card where there are two or more."""
    from intool_rag_tpu_torch.parallel.mesh import local_devices

    meshes = [(f"virtual {n}", make([dev] * n)) for n in sizes]
    if torch.cuda.device_count() >= 2:
        devices = local_devices()
        meshes.append((f"real {len(devices)}", make(devices)))
    return meshes


def _greedy(model, ids: torch.Tensor, new: int) -> torch.Tensor:
    from intool_rag_tpu_torch.models.decoder import generate

    return generate(model, ids, torch.ones_like(ids), max_new_tokens=new)


def _decode_ms(model, ids: torch.Tensor) -> float:
    """ms a decode step at batch 1 (wall through ``generate``: the
    difference of ``TP_TIMED_STEPS + 1`` new tokens and 1, medians of 2)."""

    def wall(n: int) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _greedy(model, ids, n)
        torch.cuda.synchronize()
        return 1000 * (time.perf_counter() - t0)

    wall(TP_TIMED_STEPS + 1)
    one = float(np.median([wall(1) for _ in range(2)]))
    full = float(np.median([wall(TP_TIMED_STEPS + 1) for _ in range(2)]))
    return (full - one) / TP_TIMED_STEPS


def _logit_check(single, tp, seq: torch.Tensor) -> dict:
    """One teacher-forced prefill of ``seq`` through both models: max |diff|
    against the largest |logit|, the least cosine over positions, and the
    greedy token of every position: equal wherever the single device's
    top-2 gap exceeds the max |diff|."""
    pos = torch.arange(seq.shape[1], device=seq.device).expand_as(seq)
    with torch.no_grad():
        want = single(seq, pos, single.init_cache(seq.shape[0], positions=seq.shape[1]))
        got = tp(seq, pos, tp.init_cache(seq.shape[0], positions=seq.shape[1]))
    top2 = torch.topk(want, 2, dim=-1).values
    gaps = top2[..., 0] - top2[..., 1]
    max_diff = float((got - want).abs().max())
    clear = gaps > max_diff
    return {"max_abs_diff": max_diff, "max_abs_logit": float(want.abs().max()),
            "min_cosine": float(torch.nn.functional.cosine_similarity(got, want, dim=-1).min()),
            "positions": int(gaps.numel()), "positions_clear_of_ties": int(clear.sum()),
            "greedy_equal_where_clear": bool((got.argmax(-1) == want.argmax(-1))[clear].all())}


def _tp_decode(state: dict, dev) -> dict:
    """(a) TinyLlama width, random weights: the f32 copy's greedy tokens and
    scheduler tokens equal one device's at tp 2 and 4; the bf16 model's
    logits within phase 8's bar and its greedy tokens equal up to the first
    near-tie; ms a token at tp 1 / 2 / 4."""
    from intool_rag_tpu_torch.models.decoder import DecoderConfig, DecoderLM, init_decoder_params
    from intool_rag_tpu_torch.models.scheduler import ContinuousGenerator
    from intool_rag_tpu_torch.parallel.mesh import Mesh
    from intool_rag_tpu_torch.parallel.tp_decoder import shard_decoder_params

    cfg = DecoderConfig.tinyllama()
    if (cfg.num_layers, cfg.num_heads, cfg.num_kv_heads, cfg.intermediate_size, cfg.vocab_size) != TINYLLAMA_WIDTH:
        raise AssertionError(f"phase 14 expects the TinyLlama width, got {cfg}")
    gen = torch.Generator(device=dev).manual_seed(MP_SEED)
    params = init_decoder_params(cfg, gen)
    f32 = DecoderLM(dataclasses.replace(cfg, dtype="float32"), device=dev).eval()
    f32.load_state_dict(params)
    bf16 = DecoderLM(cfg, device=dev).eval()
    bf16.load_state_dict(params)
    del params
    ids = torch.randint(3, cfg.vocab_size, (TP_PROMPTS, TP_PROMPT_LEN), generator=gen, device=dev)
    sched_prompts = [torch.randint(3, cfg.vocab_size, (int(n),), generator=gen, device=dev).tolist()
                     for n in (24, 40, 56, 72)[:TP_SCHED[0]]]
    with torch.no_grad():
        want_f32 = _greedy(f32, ids, TP_NEW)
        want_bf16 = _greedy(bf16, ids, TP_NEW)
        want_sched, _ = ContinuousGenerator(f32, n_slots=TP_SCHED[1]).generate_many(sched_prompts, TP_SCHED[2])
    seq = torch.cat([ids, want_bf16], dim=1)  # the bf16 single device's own sequence, teacher-forced
    out = {"config": "tinyllama", "prompts": [TP_PROMPTS, TP_PROMPT_LEN], "new_tokens": TP_NEW, "degrees": {}}
    timed = {"tp 1": bf16}
    for label, mesh in _meshes_of(lambda d: Mesh(d, ("model",)), TP_DEGREES, dev):
        tp = mesh.shape["model"]
        t0 = time.perf_counter()
        tp_f32, tp_bf16 = (shard_decoder_params(m, mesh) for m in (f32, bf16))
        shard_s = time.perf_counter() - t0
        with torch.no_grad():
            got_f32 = _greedy(tp_f32, ids, TP_NEW)
            got_bf16 = _greedy(tp_bf16, ids, TP_NEW)
            got_sched, sched_stats = ContinuousGenerator(tp_f32, n_slots=TP_SCHED[1]).generate_many(
                sched_prompts, TP_SCHED[2])
        logits = _logit_check(bf16, tp_bf16, seq)
        row = {
            "mesh": label, "tp": tp, "shard_s": shard_s,
            "f32_greedy_equal": bool(torch.equal(got_f32, want_f32)),
            "f32_scheduler_equal": got_sched == want_sched, "scheduler_tokens": sched_stats["total_tokens"],
            "bf16_logits": logits,
            # free-running bf16 tokens part at the first near-tie, then follow other prefixes (a reading)
            "bf16_share_equal": float((got_bf16 == want_bf16).float().mean()),
        }
        out["degrees"][label] = row
        log(f"phase 14 (a) TP decode {label}: {json.dumps(row)}")
        bar = BF16_CACHE_REL * logits["max_abs_logit"]
        if not (row["f32_greedy_equal"] and row["f32_scheduler_equal"]
                and logits["greedy_equal_where_clear"] and logits["positions_clear_of_ties"] > 0
                and logits["max_abs_diff"] <= bar and logits["min_cosine"] >= BF16_CACHE_COS):
            raise AssertionError(f"phase 14 (a) TP decode {label}: {json.dumps(row)}")
        del tp_f32
        timed[label] = tp_bf16
    del f32
    torch.cuda.empty_cache()
    one = ids[:1]
    out["ms_per_token"] = {label: _decode_ms(m, one) for label, m in timed.items()}
    out["card"] = card_line()
    log(f"phase 14 (a) decode ms a token, batch 1, {TP_PROMPT_LEN}-token prompt, bf16: "
        f"{json.dumps(out['ms_per_token'])}")
    state["mp_decode"] = timed  # launches a token: profiled after the last phase
    return out


def model_parallel_launches(state: dict) -> None:
    """Launches and device busy ms a decode token at each tp, from
    ``torch.profiler`` over ``generate`` with 1 and ``TP_PROFILED_STEPS + 1``
    new tokens (after the last phase: a profiler window slows later host work)."""
    models = state.pop("mp_decode")
    out = {}
    for label, model in models.items():
        dev = model.embed.weight.device
        ids = torch.randint(3, model.config.vocab_size, (1, TP_PROMPT_LEN),
                            generator=torch.Generator(device=dev).manual_seed(MP_SEED), device=dev)
        with torch.no_grad():
            one = _profiled_kernels(lambda: _greedy(model, ids, 1))
            full = _profiled_kernels(lambda: _greedy(model, ids, TP_PROFILED_STEPS + 1))
        if not full:
            out[label] = "not measured: torch.profiler reported no device time"
            continue
        out[label] = {
            "launches_per_token": (sum(c for _, _, c in full) - sum(c for _, _, c in one)) / TP_PROFILED_STEPS,
            "device_busy_ms_per_token": (sum(ms for _, ms, _ in full) - sum(ms for _, ms, _ in one))
            / TP_PROFILED_STEPS,
        }
    state["model_parallel"]["tp_decode"]["profile"] = out
    log(f"phase 14 (a) decode launches a token under torch.profiler: {json.dumps(out)}")


def _sp_encode(dev) -> dict:
    """(b) ``bge_m3`` width, B 1, S 8,192: the sequence-parallel embeddings
    against the single-device forward (K5), bf16, at seq meshes of 2 and 4;
    an f32 copy at depth 2 against the single-device key-mask route."""
    from intool_rag_tpu_torch.models.encoder import EncoderConfig, TextEncoder
    from intool_rag_tpu_torch.parallel.sequence import seq_mesh, sp_encode_fn

    cfg = EncoderConfig.bge_m3()
    if (cfg.num_layers, cfg.hidden_size, cfg.num_heads) != INGEST_WIDTH[:3]:
        raise AssertionError(f"phase 14 expects the bge_m3 width, got {cfg}")
    gen = torch.Generator(device=dev).manual_seed(MP_SEED)
    model = TextEncoder(cfg, device=dev).init_random(gen).eval()
    ids = torch.randint(4, cfg.vocab_size, (1, SP_LEN), generator=gen, device=dev)
    mask = (torch.arange(SP_LEN, device=dev) < SP_VALID).long()[None]
    ids = torch.where(mask.bool(), ids, cfg.pad_token_id)
    ids[:, 0] = 0

    def peak_mb(fn) -> float:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - base) / 1e6

    out = {"config": "bge_m3", "batch": 1, "seq": SP_LEN, "valid": SP_VALID, "meshes": {}}
    with torch.no_grad():
        ref = model(ids, mask)  # the K5 route
        out["single_device"] = {"ms": cuda_ms(lambda: model(ids, mask), iters=3, warmup=1),
                                "peak_mb_above_resident": peak_mb(lambda: model(ids, mask))}
        log(f"phase 14 (b) one device (the K5 route): {json.dumps(out['single_device'])}")
        for label, mesh in _meshes_of(seq_mesh, SP_SHARDS, dev):
            fn = sp_encode_fn(cfg, mesh)
            emb = fn(model, ids, mask)
            cos = float(torch.nn.functional.cosine_similarity(emb, ref, dim=-1).min())
            row = {"shards": mesh.shape["seq"], "min_cosine": cos, "ms": cuda_ms(lambda: fn(model, ids, mask),
                                                                               iters=2, warmup=1),
                   "peak_mb_above_resident": peak_mb(lambda: fn(model, ids, mask))}
            out["meshes"][label] = row
            log(f"phase 14 (b) SP encode {label}: {json.dumps(row)}")
            if cos < 0.999 or emb.shape != ref.shape or not bool(torch.isfinite(emb).all()):
                raise AssertionError(f"phase 14 (b) SP encode {label}: {row}")
        small = dataclasses.replace(cfg, num_layers=2, dtype="float32", flash_min_len=0)
        f32 = TextEncoder(small, device=dev).eval()
        f32.load_state_dict({k: v for k, v in model.state_dict().items()
                             if not k.startswith("layers.") or int(k.split(".")[1]) < 2})
        del model
        torch.cuda.empty_cache()
        ref32 = f32(ids, mask)  # the key-mask route
        hid32 = f32(ids, mask, pool=False)[mask.bool()]
        out["f32_depth_2"] = {}
        for label, mesh in _meshes_of(seq_mesh, SP_SHARDS, dev):
            got = sp_encode_fn(small, mesh)(f32, ids, mask)
            hid = sp_encode_fn(small, mesh, pool=False)(f32, ids, mask)[mask.bool()]
            row = {"max_abs_err": float((got - ref32).abs().max()),
                   "hidden_max_abs_err": float((hid - hid32).abs().max())}  # a reading, not a bar
            out["f32_depth_2"][label] = row
            if row["max_abs_err"] > SP_F32_ATOL:
                raise AssertionError(f"phase 14 (b) f32 depth 2 {label}: {row}")
        log(f"phase 14 (b) f32 copy at depth 2 against the key-mask route: {json.dumps(out['f32_depth_2'])}")
    out["card"] = card_line()
    return out


def _mp_losses(step, state, batch, steps: int) -> tuple[list[float], list[float]]:
    losses, ms = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step(state, batch)[1])
        torch.cuda.synchronize()
        ms.append(1000 * (time.perf_counter() - t0))
    return [float(x) for x in torch.stack(losses).cpu()], ms


class _KeepGrads(torch.optim.Optimizer):
    """An optimizer that takes no step and leaves the gradients on the
    parameters: a train step's gradients, read after it."""

    def __init__(self, params) -> None:
        super().__init__(params, {})

    def step(self, closure=None):
        return None

    def zero_grad(self, set_to_none: bool = True) -> None:
        return None


def _step_grads(step, model, batch, gather) -> dict:
    """The gradients of one call of ``step`` at ``model``'s weights, by
    state-dict name (``gather(model)``); the weights stay as they were."""
    from intool_rag_tpu_torch.train.contrastive import TrainState

    step(TrainState(model, _KeepGrads(model.parameters())), batch)
    return gather(model)


def _grad_distance(got: dict, want: dict) -> dict:
    """Each leaf's ``|got - want| / |want|`` (Frobenius norms), and over all
    leaves at once (``"all"``)."""
    out, num, den = {}, 0.0, 0.0
    for name, w in want.items():
        d = float(torch.linalg.vector_norm((got[name].to(w.device) - w).double()))
        n = float(torch.linalg.vector_norm(w.double()))
        out[name] = d / max(n, 1e-30)
        num, den = num + d * d, den + n * n
    out["all"] = math.sqrt(num) / max(math.sqrt(den), 1e-30)
    return out


def _dp_tp_train(state: dict, dev, total: dict) -> dict:
    """(c) the DP+TP step at ``bge_m3`` width on ``train_mesh`` (data 2,
    model 2) of the one card: phase 7's first run (its initial weights and
    batch), 3 steps against the single-device step, two runs bit-equal,
    K5 launches counted; the first step's bf16 gradients, leaf by leaf,
    against the single-device f32 step's beside the single-device bf16
    step's; then an f32 copy at depth 2."""
    from intool_rag_tpu_torch.models.encoder import EncoderConfig, TextEncoder
    from intool_rag_tpu_torch.parallel.mesh import train_mesh
    from intool_rag_tpu_torch.train.contrastive import (
        TrainState, make_optimizer, make_sharded_train_step, make_train_step, shard_params,
    )

    cfg = EncoderConfig.bge_m3()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    pairs, s_p = TRAIN_RUNS[0][1:]
    gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED)  # phase 7's draws, in its order
    model = TextEncoder(cfg, device=dev, param_dtype=torch.float32).init_random(gen).train()
    init = {k: v.clone() for k, v in model.state_dict().items()}
    batch = _train_batch(gen, cfg, pairs, s_p, dev)

    def single(config, weights):
        m = TextEncoder(config, device=dev, param_dtype=torch.float32).train()
        m.load_state_dict(weights)
        return m

    def single_grads(config) -> dict:
        m = single(config, init)
        return _step_grads(make_train_step(config), m, batch, lambda m: {n: p.grad for n, p in m.named_parameters()})

    # the first step's gradients at the initial weights: f32 (the reference: no rounding to
    # speak of) and bf16 compute on one device; the sharded step's are held against both below
    grads32, grads_bf = single_grads(cfg32), single_grads(cfg)
    single_err = _grad_distance(grads_bf, grads32)
    del grads_bf
    train_state = TrainState(model, *make_optimizer(model, TRAIN_LR))
    single_losses, single_ms = _mp_losses(make_train_step(cfg), train_state, batch, MP_STEPS)
    # the single device's own spread: the same step on the pairs in another order (the same
    # loss, summed in another order); at random weights the bf16 gradient is mostly rounding
    # noise, and Adam's first updates carry it into the later losses
    model.load_state_dict(init)
    train_state = TrainState(model, *make_optimizer(model, TRAIN_LR))
    perm = torch.roll(torch.arange(pairs, device=dev), 1)
    permuted, _ = _mp_losses(make_train_step(cfg), train_state, {k: v[perm] for k, v in batch.items()}, MP_STEPS)
    spread = [abs(a - b) / abs(b) for a, b in zip(permuted, single_losses)]
    del model, train_state
    m32 = single(cfg32, init)
    losses32, _ = _mp_losses(make_train_step(cfg32), TrainState(m32, *make_optimizer(m32, TRAIN_LR)), batch,
                             MP_STEPS)
    del m32
    torch.cuda.empty_cache()
    log(f"phase 14 (c) single device, phase 7's first run: losses {single_losses}, step ms {single_ms}; "
        f"the pairs in another order: losses {permuted} (relative {spread}); f32 compute: losses {losses32}; "
        f"the first bf16 gradient's distance to the f32 one: all {single_err['all']}, "
        f"worst {json.dumps(dict(sorted(single_err.items(), key=lambda kv: -kv[1])[:4]))}")

    def sharded_run(config, weights, mesh):
        sharded = shard_params(single(config, weights), mesh)
        st = TrainState(sharded, *make_optimizer(sharded, TRAIN_LR))
        step, place = make_sharded_train_step(config, mesh)
        placed = place(batch)
        _reset_k5_counts()  # the main path: counts set to 0 just before, read just after
        losses, ms = _mp_losses(step, st, placed, MP_STEPS)
        counts = _k5_counts()
        return losses, ms, counts, sharded.gather_state_dict()

    def worst(err: dict, n: int = 4) -> dict:
        return dict(sorted(err.items(), key=lambda kv: -kv[1])[:n])

    out = {"config": "bge_m3", "queries": [pairs, TRAIN_Q_LEN], "passages": [pairs, s_p], "steps": MP_STEPS,
           "single_device": {"losses": single_losses, "step_ms": single_ms, "pairs_permuted_losses": permuted,
                             "pairs_permuted_rel": spread, "f32_losses": losses32,
                             "grad_rel_to_f32": {"all": single_err["all"], "worst": worst(single_err)}},
           "meshes": {}}
    for label, mesh in _meshes_of(lambda d: train_mesh(d, model_parallel=2), (4,), dev):
        dp, tp = mesh.shape["data"], mesh.shape["model"]
        want = {name: cfg.num_layers * tp * dp * MP_STEPS for name in ("K5 bf16", "K5 dkv bf16", "K5 dq bf16")}
        sharded = shard_params(single(cfg, init), mesh)
        tp_err = _grad_distance(_step_grads(make_sharded_train_step(cfg, mesh)[0], sharded, batch,
                                            lambda m: m.gather_state_dict(grads=True)), grads32)
        del sharded
        # each leaf's distance to the f32 gradient over the single device's bf16 distance
        ratio = {n: tp_err[n] / max(single_err[n], 1e-30) for n in tp_err}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        losses, ms, counts, weights = sharded_run(cfg, init, mesh)
        peak_mb = torch.cuda.max_memory_allocated() / 1e6
        again, _, counts2, weights2 = sharded_run(cfg, init, mesh)
        bit_equal = again == losses and all(torch.equal(weights[k], weights2[k]) for k in weights)
        del weights, weights2
        torch.cuda.empty_cache()
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, single_losses)]
        rel32 = [abs(a - b) / abs(b) for a, b in zip(losses, losses32)]
        row = {"data": dp, "model": tp, "losses": losses, "loss_rel_to_single": rel, "loss_rel_to_f32": rel32,
               "grad_rel_to_f32": {"all": tp_err["all"], "worst": worst(tp_err)},
               "grad_ratio_to_single": {"all": ratio["all"], "worst": worst(ratio)}, "step_ms": ms,
               "step_ms_after_first": float(np.median(ms[1:])), "single_step_ms_after_first":
               float(np.median(single_ms[1:])), "phase_7_step_ms_after_first":
               state.get("train", {}).get("runs", [{}])[0].get("step_ms_after_first"),
               "launches": counts["launches"], "expected_launches": want, "repeat_bit_equal": bit_equal,
               "peak_mb": peak_mb}
        out["meshes"][label] = row
        log(f"phase 14 (c) DP+TP step {label}: {json.dumps(row)}")
        # the bars on bf16: the first loss (the same weights) within MP_LOSS_REL of one device's,
        # and the first step's gradient, every leaf, no further from the f32 step's than
        # MP_GRAD_RATIO times the single-device bf16 step's; later losses are printed
        if counts["launches"] != want or counts["plain_forward"] or counts["plain_backward"] \
                or counts2["launches"] != want or rel[0] > MP_LOSS_REL or not losses[-1] < losses[0] \
                or max(ratio.values()) > MP_GRAD_RATIO \
                or not bit_equal or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"phase 14 (c) DP+TP step {label}: {json.dumps(row)}")
        if label == "virtual 4":
            for name, count in want.items():
                total[name] = total.get(name, 0) + count
    del grads32
    # an f32 copy at depth 2 (the K5 f32 kernels): losses to rtol 1e-5
    small = dataclasses.replace(cfg32, num_layers=2)
    weights = {k: v for k, v in init.items() if not k.startswith("layers.") or int(k.split(".")[1]) < 2}
    del init
    m = single(small, weights)
    single32, _ = _mp_losses(make_train_step(small), TrainState(m, *make_optimizer(m, TRAIN_LR)), batch, MP_STEPS)
    del m
    mesh = train_mesh([dev] * 4, model_parallel=2)
    got32, _, _, _ = sharded_run(small, weights, mesh)
    rel32 = [abs(a - b) / abs(b) for a, b in zip(got32, single32)]
    out["f32_depth_2"] = {"losses": got32, "single_device": single32, "rel": rel32}
    log(f"phase 14 (c) f32 copy at depth 2: {json.dumps(out['f32_depth_2'])}")
    if max(rel32) > MP_F32_RTOL:
        raise AssertionError(f"phase 14 (c) f32 depth 2: {out['f32_depth_2']}")
    out["card"] = card_line()
    return out


def phase_model_parallel(state: dict) -> None:
    """Phase 14: model parallelism on the card (``parallel/tp_decoder.py``,
    ``parallel/sequence.py``, the DP+TP step of ``train/contrastive.py``),
    on virtual meshes of the one card (and on every card where there are
    two or more). No plain version may run; the DP+TP step's K5 launches are
    its main path's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    dev = torch.device(DEVICE)
    log(f"phase 14: {torch.cuda.device_count()} CUDA device(s); the virtual meshes put every shard on {dev}, "
        "one after another")
    total: dict[str, int] = {}
    results: dict = {"devices": torch.cuda.device_count(), "card": card_line()}
    state["model_parallel"] = results
    with _KernelsNoPlain("phase 14"):
        t0 = time.perf_counter()
        results["tp_decode"] = _tp_decode(state, dev)
        results["tp_decode"]["s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        results["sp_encode"] = _sp_encode(dev)
        results["sp_encode"]["s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        results["dp_tp_train"] = _dp_tp_train(state, dev, total)
        results["dp_tp_train"]["s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    results["launches"] = total
    for row in state.get("kernels", []):
        row["launches_model_parallel"] = total.get(row["name"], 0)
    log(f"phase 14 main-path launches (the DP+TP step): {json.dumps(total)}")


# ------------------------------------------------------------------ phase 15

DS_ROWS = 32  # the query cell's slots: the rows of a one-token step
MLA_SHAPES = ((100, 2600), (0, 8192))  # positions [first, end) of the timed MLA calls, 32 rows × 16 heads
MLA_LAYERS = 4  # caches the timed calls cycle over: 4 × 302 MB, past the 50 MB L2
DS_STEP_LAYERS = 2  # the step's model: V2-Lite's widths, its dense first layer and one expert layer
DS_STEP_CURSOR = 2500  # the step's cache holds this many positions, from DS_STEP_FIRST on
DS_STEP_FIRST = 100
DS_STEPS = 4
DS_PLAIN = ("rms_norm_reference", "mla_rope_latent_reference", "mla_decode_reference", "moe_router_reference",
            "moe_combine_reference")


def _ds_ops():
    from intool_rag_tpu_torch.ops import deepseek_decode as fused

    return fused, (fused.rms_norm, fused.mla_rope_latent, fused.mla_decode, fused.moe_router, fused.moe_combine)


def _ds_launches() -> dict[str, dict[str, int]]:
    _, ops = _ds_ops()
    return {op.__name__: dict(op.launches.by_variant) for op in ops}


def _ds_reset() -> None:
    for op in _ds_ops()[1]:
        op.launches.reset()


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm().clamp(min=1e-30))


def _ds_wrappers(cfg, gen) -> dict:
    """Each op of ``kernels/deepseek_decode.cu`` on card tensors at V2-Lite's
    widths (32 rows; 64 experts, top-6) against its plain version, with
    the card tests' tolerances; the launch counts set to 0 before and read
    after (one launch each)."""
    from intool_rag_tpu_torch.models import deepseek_v2 as ds

    fused, _ = _ds_ops()
    t, h, e, k = DS_ROWS, cfg.hidden_size, cfg.n_routed_experts, cfg.num_experts_per_tok
    nh, dn, dr, r = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.kv_lora_rank
    eps = cfg.rms_norm_eps
    _ds_reset()
    out = {}
    x = torch.randn(t, h, generator=gen, device=DEVICE).bfloat16()
    res = torch.randn(t, h, generator=gen, device=DEVICE).bfloat16()
    w = (torch.rand(h, generator=gen, device=DEVICE) + 0.5).bfloat16()
    (total, got), (want_total, want) = (fused.rms_norm(x, w, eps, residual=res),
                                        fused.rms_norm_reference(x, w, eps, residual=res))
    out["rms_norm"] = rel = _rel_err(got, want)
    if not (torch.equal(total, want_total) and rel < 2e-3):
        raise AssertionError(f"rms_norm: sum equal {torch.equal(total, want_total)}, relative error {rel}")

    qkv = torch.randn(t, nh * (dn + dr) + r + dr, generator=gen, device=DEVICE).bfloat16()
    positions = torch.randint(0, 8192, (t,), generator=gen, device=DEVICE)
    kv_w = (torch.rand(r, generator=gen, device=DEVICE) + 0.5).bfloat16()
    args = (positions, ds.yarn_inv_freq(cfg, DEVICE), 1.0, kv_w, eps, nh, dn, dr, r)
    got_pe, got_lat = fused.mla_rope_latent(qkv, *args)
    want_pe, want_lat = fused.mla_rope_latent_reference(qkv, *args)
    out["mla_rope_latent"] = rel = _rel_err(got_lat[:, :r], want_lat[:, :r])
    if not (torch.equal(got_pe, want_pe) and torch.equal(got_lat[:, r:], want_lat[:, r:]) and rel < 2e-3):
        raise AssertionError(f"mla_rope_latent: rope not bit-equal, or the latent's norm off by {rel}")

    kv = (torch.randn(t, 8192, r + dr, generator=gen, device=DEVICE) * 0.5).bfloat16()
    valid = torch.rand(t, 8192, generator=gen, device=DEVICE) > 0.2
    valid[3] = False  # a row that sees only its own position
    q_lat = (torch.randn(nh, t, r, generator=gen, device=DEVICE) * 0.2).bfloat16()
    q_pe = (torch.randn(t, nh, dr, generator=gen, device=DEVICE) * 0.2).bfloat16()
    got = fused.mla_decode(q_lat, q_pe, kv, valid, DS_STEP_FIRST, DS_STEP_CURSOR, 0.1147214)
    want = fused.mla_decode_reference(q_lat, q_pe, kv, valid, DS_STEP_FIRST, DS_STEP_CURSOR, 0.1147214)
    out["mla_decode"] = rel = _rel_err(got, want)
    if not (rel < 1e-2 and torch.equal(got[:, 3], kv[3, DS_STEP_CURSOR - 1, :r].expand(nh, r))):
        raise AssertionError(f"mla_decode: relative error {rel}, or the lone row not its own entry")

    logits = torch.randn(t, e, generator=gen, device=DEVICE) * 0.3
    real = torch.rand(t, generator=gen, device=DEVICE) > 0.25
    tally, want_tally = (torch.zeros((2, 3), dtype=torch.int64, device=DEVICE) for _ in range(2))
    got = fused.moe_router(logits, k, cfg.routed_scaling_factor, real, tally, tally_rows=2)
    want = fused.moe_router_reference(logits, k, cfg.routed_scaling_factor, real, want_tally, tally_rows=2)
    out["moe_router"] = rel = _rel_err(got, want)
    if not (torch.equal(got != 0, want != 0) and torch.equal(tally, want_tally)
            and torch.allclose(got, want, rtol=2e-6, atol=0)):
        raise AssertionError(f"moe_router: routes, tally or gates (relative error {rel}) differ")

    experts = torch.randn(e, t, h, generator=gen, device=DEVICE).bfloat16()
    gates = want
    out["moe_combine"] = rel = _rel_err(fused.moe_combine(experts, gates), fused.moe_combine_reference(experts, gates))
    if not rel < 2e-3:
        raise AssertionError(f"moe_combine: relative error {rel}")
    launches = _ds_launches()
    if any(sum(v.values()) != 1 for v in launches.values()):
        raise AssertionError(f"phase 15: one launch an op expected, got {launches}")
    return {"rel_err": out, "launches": launches}


def _ds_steps(cfg) -> dict:
    """``_DecodeSteps`` of a bf16 model at V2-Lite's widths cut to
    ``DS_STEP_LAYERS`` layers, 32 rows over a cache of ``DS_STEP_CURSOR``
    positions: the first call builds the graphs, then ``DS_STEPS`` calls
    with every launch count set to 0 just before and no plain version
    allowed. A replayed graph launches without its wrapper, so the counts
    hold one ``mla_decode`` a layer a step (the eager attention) and nothing
    else. The graphed step's logits against the layers' own step (grad mode
    on) from the same cache, within 2e-2 relative."""
    import dataclasses

    from intool_rag_tpu_torch.models import deepseek_v2 as ds

    fused, _ = _ds_ops()
    small = dataclasses.replace(cfg, num_layers=DS_STEP_LAYERS)
    model = ds.DeepseekV2LM(small, device=DEVICE).init_random(15).eval()
    gen = torch.Generator(device=DEVICE).manual_seed(16)
    cache, eager = model.init_cache(DS_ROWS), model.init_cache(DS_ROWS)
    cache.kv[:, :, :DS_STEP_CURSOR] = (torch.randn(cache.kv[:, :, :DS_STEP_CURSOR].shape, generator=gen,
                                                   device=DEVICE) * 0.5).bfloat16()
    cache.valid[:, DS_STEP_FIRST:DS_STEP_CURSOR] = torch.rand(DS_ROWS, DS_STEP_CURSOR - DS_STEP_FIRST, generator=gen,
                                                              device=DEVICE) > 0.2
    eager.kv.copy_(cache.kv)
    eager.valid.copy_(cache.valid)
    for c in (cache, eager):
        c.length, c.first = DS_STEP_CURSOR, DS_STEP_FIRST
    ids = torch.randint(0, small.vocab_size, (DS_ROWS, 1), generator=gen, device=DEVICE)
    pos = torch.full((DS_ROWS, 1), DS_STEP_CURSOR, device=DEVICE)
    with torch.no_grad():
        got = model(ids, pos, cache)  # builds the graphs
    with torch.enable_grad():
        want = model(ids, pos, eager).detach()
    rel = _rel_err(got, want)
    if not (torch.isfinite(got).all() and rel < 2e-2):
        raise AssertionError(f"phase 15: the graphed step's logits {rel} from the layers' own")
    boxes = [_counting(fused, name) for name in DS_PLAIN]
    try:
        _ds_reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            for j in range(DS_STEPS):
                model(ids, pos + 1 + j, cache)
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0) / DS_STEPS
        launches = _ds_launches()
    finally:
        for name, (_, original) in zip(DS_PLAIN, boxes):
            setattr(fused, name, original)
    plain = sum(box["calls"] for box, _ in boxes)
    want_launches = {"mla_decode": {"mma+combine": DS_STEPS * DS_STEP_LAYERS}}
    if plain or {k: v for k, v in launches.items() if v} != want_launches:
        raise AssertionError(f"phase 15 steps: launched {launches}, plain versions called {plain} times; expected "
                             f"{want_launches} and none")
    return {"layers": DS_STEP_LAYERS, "steps": DS_STEPS, "logits_rel_err": rel, "launches": launches,
            "step_ms_host": step_ms}


def phase_mla(state: dict) -> None:
    from intool_rag_tpu_torch.models import deepseek_v2 as ds

    fused, _ = _ds_ops()
    cfg = ds.DeepseekV2Config.lite()
    r, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    gen = torch.Generator(device=DEVICE).manual_seed(15)
    out = {"ops": _ds_wrappers(cfg, gen)}
    log(f"phase 15 ops against their plain versions: {json.dumps(out['ops'])}")
    out["step"] = _ds_steps(cfg)
    log(f"phase 15 one-token steps: {json.dumps(out['step'])}")
    torch.cuda.empty_cache()
    results = []
    for first, end in MLA_SHAPES:
        b, h = DS_ROWS, cfg.num_heads
        kv = (torch.randn(MLA_LAYERS, b, 8192, r + dr, generator=gen, device=DEVICE) * 0.5).bfloat16()
        valid = torch.rand(b, 8192, generator=gen, device=DEVICE) > 0.2
        q_lat = (torch.randn(h, b, r, generator=gen, device=DEVICE) * 0.2).bfloat16()
        q_pe = (torch.randn(b, h, dr, generator=gen, device=DEVICE) * 0.2).bfloat16()
        got = fused.mla_decode(q_lat, q_pe, kv[0], valid, first, end, 0.1147214)
        want = fused.mla_decode_reference(q_lat, q_pe, kv[0], valid, first, end, 0.1147214)
        rel = _rel_err(got, want)
        if not rel < 1e-2:
            raise AssertionError(f"mla_decode at {(b, h, first, end)}: relative error {rel}")
        calls = iter(range(1 << 30))

        def kernel():
            return fused.mla_decode(q_lat, q_pe, kv[next(calls) % MLA_LAYERS], valid, first, end, 0.1147214)

        _ds_reset()
        kernel_ms = cuda_ms(kernel, iters=200, warmup=8)
        launches = _ds_launches()["mla_decode"]
        plain_ms = cuda_ms(lambda: fused.mla_decode_reference(q_lat, q_pe, kv[1], valid, first, end, 0.1147214))
        bound_ms = 1e3 * b * (end - first) * (r + dr) * 2 / H100_HBM_BYTES_S
        row = {"rows": b, "heads": h, "positions": end - first, "kernel_us": 1e3 * kernel_ms,
               "bound_us": 1e3 * bound_ms, "share": bound_ms / kernel_ms, "plain_us": 1e3 * plain_ms,
               "rel_err": rel, "launches": launches}
        log(f"phase 15 mla_decode {json.dumps(row)}")
        results.append(row)
        del kv
        torch.cuda.empty_cache()
    out["mla_decode"] = results
    state["deepseek"] = out


PHASES = {1: phase_build, 2: phase_kernels, 3: phase_service, 4: phase_scale, 5: phase_capacity,
          6: phase_ingest, 7: phase_train, 8: phase_query, 9: phase_served, 10: phase_scanned,
          11: phase_tiers, 12: phase_training, 13: phase_sharded, 14: phase_model_parallel, 15: phase_mla}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default="1,2,3,4,5,6,7,8,9,10,11,12,13,14,15")
    parser.add_argument("--trace-windows", type=int, default=1,
                        help="repeat phase 9's /debug/trace window this many times")
    args = parser.parse_args(argv)
    faulthandler.enable()  # a crash in native code prints every thread's Python stack
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    phases = [int(p) for p in args.phases.split(",")]
    state: dict = {"phases": phases, "environ": dict(os.environ)}
    for p in phases:
        t0 = time.perf_counter()
        PHASES[p](state)
        log(f"phase {p} done in {time.perf_counter() - t0:.1f} s")
    # torch.profiler windows come last: they slow later host work (see scale_busy_share)
    if "scale_batch" in state:
        scale_busy_share(state)
    if "decode_llm" in state:
        decode_busy_share(state)
    if "scan_engines" in state:
        scanned_busy_share(state)
    if "lm_profile" in state:
        lm_busy_share(state)
    if "mp_decode" in state:
        model_parallel_launches(state)
    if "served_trace" in state:
        served_trace(state, args.trace_windows)
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
