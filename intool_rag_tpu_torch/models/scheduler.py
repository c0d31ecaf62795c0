"""Continuous batching for the decoder: slot-refill serving (port of
``intool_rag_tpu/models/scheduler.py``).

- ``n_slots`` streams decode together in ``seg_len``-token segments over one
  cache with a shared write cursor ``L``; RoPE positions stay stream-local
  (each stream's tokens are positions 0..n-1), so a stream's tokens do not
  depend on which slot or cursor it got.
- Between segments, freed slots are refilled from the queue: a refill group
  prefills in one batched call through a trimmed cache of the prompt bucket
  ``S`` (:meth:`ContinuousGenerator._insert`), and its K/V lands at
  positions ``[L - S, L)`` of the group's slots; the slots' earlier history
  is cleared through ``valid``, so no stream sees its slot's last tenant.
- Every per-slot serving state (next token, position, active flag,
  remaining budget) lives on the device and a segment reads nothing back:
  a stream's budget and EOS retire it on the device. The host dispatches
  segment N before it reads segment N-1's results (copied to pinned host
  memory behind an event), a depth-2 pipeline: a slot freed in segment N is
  refilled at N+2.
- When the cursor would pass the cache's end, the pipeline is drained and
  every live stream's history (prompt and tokens so far) is prefilled again
  into a fresh cache (:meth:`ContinuousGenerator._compact`); K/V depends on
  the prefix only, so the tokens do not change (in f32; see below).

Speculative waves (``speculative_gamma`` > 1, greedy only): each decode
step becomes a ``gamma``-token verification wave. Every slot drafts
``gamma - 1`` tokens by looking up its last bigram in its own rolling
window of history (prompt and generated tokens), one batched forward
verifies every slot, and each slot keeps its accepted prefix and the
model's own next token; the rejected slots become invalid positions. The
cursor advances ``gamma`` a wave whatever was accepted.

Parity: every emitted token is the model's argmax (or its sample) after the
same prefix, so in f32 the tokens equal the static ``generate``'s. In bf16 a
batched step, a ``gamma``-token verify or a re-prefill after compaction sums
in another order than one stream's one-token step, and near-ties of the
argmax can go the other way.

Differences from the JAX scheduler: a refill group is as wide as its
members (eager PyTorch has no compiled shapes to keep, so there are no
filler rows); ``SPEC_WAVES_PER_SEGMENT`` is not read; sampling draws from a
``torch.Generator`` seeded with ``seed``, so sampled tokens differ from the
JAX package's.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from .decoder import DecoderLM, KVCache, _sample, init_cache


@dataclasses.dataclass
class _Stream:
    idx: int  # request index
    tokens: list  # generated token ids
    max_new: int
    t_submit: float
    t_done: float | None = None


@dataclasses.dataclass
class _Slots:
    """The device serving state, one row a slot; ``win`` / ``wmask`` (the
    speculation windows, right-aligned) only when speculating."""

    tok: torch.Tensor
    pos: torch.Tensor
    active: torch.Tensor
    rem: torch.Tensor
    win: torch.Tensor | None = None
    wmask: torch.Tensor | None = None


class _Fetch:
    """Device tensors copied to the host without blocking: pinned buffers
    behind an event on the card, clones on the CPU (whose tensors the
    scheduler updates in place later)."""

    def __init__(self, tensors: list[torch.Tensor]) -> None:
        self.event = None
        if tensors[0].is_cuda:
            self.host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)
                         for t in tensors]
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = [t.clone() for t in tensors]

    def wait(self) -> list[np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return [t.numpy() for t in self.host]


def _bucket(n: int) -> int:
    """Power-of-two prompt bucket, at least 8."""
    return 1 << max(3, (n - 1).bit_length())


class ContinuousGenerator:
    """Slot-based continuous-batching generation over ``model`` (on its
    parameters' device)."""

    def __init__(
        self,
        model: DecoderLM,
        *,
        n_slots: int = 8,
        seg_len: int = 16,
        temperature: float = 0.0,
        eos_id: int | None = None,
        pad_id: int = 0,
        top_k: int = 0,
        top_p: float = 1.0,
        speculative_gamma: int = 0,
        lookup_window: int = 128,
    ) -> None:
        """``speculative_gamma`` > 1 turns every decode step into a batched
        prompt-lookup wave (greedy only; a sampling config raises). A wave
        burns ``gamma`` cursor positions, so a segment runs
        ``max(1, seg_len // gamma)`` waves: its cursor advance
        (:attr:`segment_advance`) stays within ``seg_len`` unless ``gamma``
        is larger."""
        if speculative_gamma and temperature > 0.0:
            raise ValueError("speculative decoding requires greedy sampling (temperature == 0): "
                             "acceptance is defined against the model's argmax")
        self.model = model
        self.config = model.config
        self.device = model.embed.weight.device
        self.n_slots = n_slots
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.eos = -1 if eos_id is None else eos_id
        self.pad_id = pad_id
        self.gamma = int(speculative_gamma) if speculative_gamma else 0
        self.lookup_window = int(lookup_window)
        self.seg_len = max(1, seg_len // self.gamma) if self.gamma else seg_len
        self._generator: torch.Generator | None = None

    @property
    def segment_advance(self) -> int:
        """Cursor positions one decode segment takes: what callers budget
        against ``max_position``."""
        return self.seg_len * self.gamma if self.gamma else self.seg_len

    # ---------------- device work ----------------

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        return _sample(logits, self.temperature, self.top_k, self.top_p, self._generator)

    def _pack_group(self, s_bucket: int, entries) -> tuple[np.ndarray, ...]:
        """``entries = [(slot, token ids, limit)]`` as right-aligned ids and
        mask ``[M, s_bucket]``, slots and limits ``[M]``. One packer for
        refill and compaction, so a re-prefill lays out its rows as the
        first prefill did."""
        m = len(entries)
        ids = np.full((m, s_bucket), self.pad_id, np.int64)
        mask = np.zeros((m, s_bucket), np.int64)
        slots = np.zeros(m, np.int64)
        limits = np.ones(m, np.int64)
        for j, (b, toks, limit) in enumerate(entries):
            ids[j, s_bucket - len(toks):] = toks
            mask[j, s_bucket - len(toks):] = 1
            slots[j] = b
            limits[j] = limit
        return ids, mask, slots, limits

    def _insert(self, cache: KVCache, s_bucket: int, entries, state: _Slots | None) -> torch.Tensor | None:
        """One batched prefill of a refill group through a trimmed cache of
        ``s_bucket`` positions, its K/V into positions ``[L - S, L)`` of the
        group's slots (their earlier history cleared through ``valid``), and
        the group's first tokens, positions, budgets (limit less the first
        token) and active flags into ``state``; speculation seeds each
        slot's window with the prompt's last tokens. Returns the first
        tokens ``[M]``; with ``state`` None (compaction) only the cache is
        written and nothing is sampled."""
        cfg, dev = self.config, self.device
        ids, mask, slots, limits = (torch.as_tensor(a, device=dev) for a in self._pack_group(s_bucket, entries))
        m = ids.shape[0]
        shape = (cfg.num_layers, m, s_bucket, cfg.num_kv_heads, cfg.head_dim)
        sub = KVCache(k=torch.zeros(shape, dtype=cache.k.dtype, device=dev),
                      v=torch.zeros(shape, dtype=cache.v.dtype, device=dev),
                      valid=torch.zeros((m, s_bucket), dtype=torch.bool, device=dev))
        positions = torch.clamp(torch.cumsum(mask, dim=1) - 1, min=0)
        logits = self.model(ids, positions, sub, mask.bool())
        start, end = cache.length - s_bucket, cache.length
        cache.k[:, slots, start:end] = sub.k
        cache.v[:, slots, start:end] = sub.v
        cache.valid[slots] = False
        cache.valid[slots, start:end] = sub.valid
        if state is None:
            return None
        firsts = self._sample(logits[:, -1])
        rem = limits - 1
        state.tok[slots] = firsts
        state.pos[slots] = positions[:, -1] + 1
        state.rem[slots] = rem
        state.active[slots] = (firsts != self.eos) & (rem > 0)
        if self.gamma:
            w = self.lookup_window
            if s_bucket >= w:
                seed_ids, seed_m = ids[:, -w:], mask[:, -w:].bool()
            else:
                pad = w - s_bucket
                seed_ids = torch.cat([torch.full((m, pad), self.pad_id, dtype=ids.dtype, device=dev), ids], 1)
                seed_m = torch.cat([torch.zeros((m, pad), dtype=torch.bool, device=dev), mask.bool()], 1)
            state.win[slots] = seed_ids
            state.wmask[slots] = seed_m
        return firsts

    def _decode_segment(self, cache: KVCache, st: _Slots) -> torch.Tensor:
        """``seg_len`` one-token steps for every slot → tokens ``[B, seg]``.
        An inactive slot emits pad and its cache rows stay invalid; ``rem``
        counts down and retires a stream on the device."""
        toks = []
        for _ in range(self.seg_len):
            logits = self.model(st.tok[:, None], st.pos[:, None], cache, st.active[:, None])
            nxt = torch.where(st.active, self._sample(logits[:, 0]), self.pad_id)
            st.rem = torch.where(st.active, st.rem - 1, st.rem)
            st.active = st.active & (nxt != self.eos) & (st.rem > 0)
            st.tok, st.pos = nxt, st.pos + 1
            toks.append(nxt)
        return torch.stack(toks, dim=1)

    def _draft(self, st: _Slots) -> torch.Tensor:
        """Per-slot drafts ``[B, gamma - 1]``: the tokens after the last
        place in the slot's window where (its last window token, its pending
        token) occur; -1 where there is none (it never equals an argmax, so
        the wave is one plain greedy step for that slot)."""
        win, wmask = st.win, st.wmask
        w = win.shape[1]
        hit = ((win[:, :-1] == win[:, -1:]) & (win[:, 1:] == st.tok[:, None])
               & wmask[:, :-1] & wmask[:, 1:] & wmask[:, -1:])
        match = torch.where(hit, torch.arange(w - 1, device=win.device), -1).max(dim=1).values
        jj = match[:, None] + 2 + torch.arange(self.gamma - 1, device=win.device)[None]
        ok = (match[:, None] >= 0) & (jj < w)
        jj = torch.clamp(jj, 0, w - 1)
        return torch.where(ok & torch.gather(wmask, 1, jj), torch.gather(win, 1, jj), -1)

    def _spec_wave(self, cache: KVCache, st: _Slots) -> tuple[torch.Tensor, torch.Tensor]:
        """One wave: draft, verify every slot in one ``gamma``-token forward,
        emit each slot's accepted prefix and the model's next token (1 to
        ``gamma``, cut at the budget and after an EOS), mark the rejected
        slots invalid and roll the windows. Returns (tokens ``[B, gamma]``,
        pad past each count, and counts ``[B]``)."""
        g, dev = self.gamma, self.device
        base = cache.length
        drafts = self._draft(st)
        feed = torch.cat([st.tok[:, None], torch.clamp(drafts, min=0)], dim=1)
        jcol = torch.arange(g, device=dev)[None]
        logits = self.model(feed, st.pos[:, None] + jcol, cache, st.active[:, None].expand(feed.shape))
        o = torch.argmax(logits, dim=-1)
        m = torch.cumprod((o[:, :-1] == drafts).long(), dim=1).sum(dim=1)
        c = torch.minimum(m + 1, st.rem)
        is_eos = (o == self.eos) & (jcol < c[:, None])
        e = torch.where(is_eos, jcol, g).min(dim=1).values
        c = torch.where(e < g, torch.minimum(c, e + 1), c)
        c = torch.where(st.active, c, 0)
        last = torch.gather(o, 1, torch.clamp(c - 1, min=0)[:, None])[:, 0]
        # the consumed feed is [tok, accepted drafts]; the rest of the wave is never attended to
        cache.valid[:, base : base + g] &= jcol < c[:, None]
        ext = torch.cat([st.win, st.tok[:, None], o[:, :-1]], dim=1)
        extm = torch.cat([st.wmask, jcol < c[:, None]], dim=1)
        gidx = torch.arange(st.win.shape[1], device=dev)[None] + c[:, None]
        st.win, st.wmask = torch.gather(ext, 1, gidx), torch.gather(extm, 1, gidx)
        st.rem = st.rem - c
        st.tok = torch.where(st.active, last, st.tok)
        st.pos = st.pos + c
        st.active = st.active & (e >= g) & (st.rem > 0)
        return torch.where(jcol < c[:, None], o, self.pad_id), c

    def _decode_segment_spec(self, cache: KVCache, st: _Slots) -> tuple[torch.Tensor, torch.Tensor]:
        """``seg_len`` waves → tokens ``[B, seg, gamma]`` and counts ``[B, seg]``."""
        toks, counts = zip(*(self._spec_wave(cache, st) for _ in range(self.seg_len)))
        return torch.stack(toks, dim=1), torch.stack(counts, dim=1)

    def _compact(self, prompts, slots: list, head_bucket: int = 0) -> tuple[KVCache, int]:
        """A fresh cache holding every live stream's history: its prompt and
        its tokens but the newest (not fed yet: it stays in ``tok``). The
        cursor moves to the largest history bucket (or the next queued
        prompt's, if larger); the histories are prefilled again, one batched
        call per bucket. The serving state is not touched: the caller
        uploads its host copy afterwards."""
        groups: dict[int, list] = {}
        lens = [head_bucket, 8]
        for b, st in enumerate(slots):
            if st is None:
                continue
            ids = list(prompts[st.idx]) + st.tokens[:-1]
            lens.append(len(ids))
            groups.setdefault(_bucket(len(ids)), []).append((b, ids, 1))
        cursor = _bucket(max(lens))
        fresh = init_cache(self.config, self.n_slots, self.device)
        fresh.length = cursor
        for s_bucket, entries in sorted(groups.items()):
            self._insert(fresh, s_bucket, entries, None)
        return fresh, cursor

    # ---------------- host scheduler ----------------

    @torch.no_grad()
    def generate_many(self, prompts: list[list[int]], max_new_tokens: int | list[int], *,
                      seed: int = 0) -> tuple[list[list[int]], dict]:
        """Generate for every prompt (token-id lists), streaming slots.
        Returns (tokens per prompt, EOS left out; stats)."""
        cfg, dev = self.config, self.device
        n = len(prompts)
        limits = [max_new_tokens] * n if isinstance(max_new_tokens, int) else list(max_new_tokens)
        self._generator = torch.Generator(device=dev).manual_seed(seed)
        results: list[list[int]] = [[] for _ in range(n)]
        queue = collections.deque(i for i in range(n) if limits[i] > 0)
        slots: list[_Stream | None] = [None] * self.n_slots
        # host copies of the device state, from each segment's fetch: for
        # refill planning and the upload after a compaction
        host = {"tok": np.full(self.n_slots, self.pad_id, np.int64), "pos": np.zeros(self.n_slots, np.int64),
                "active": np.zeros(self.n_slots, bool), "rem": np.zeros(self.n_slots, np.int64)}
        t0 = time.perf_counter()
        lat: list[float] = []
        n_compact = spec_tokens = spec_waves = 0
        budget_err = "stream too long for the cache: raise max_position"
        g = self.gamma
        advance = self.segment_advance

        def upload() -> _Slots:
            st = _Slots(**{k: torch.tensor(v, device=dev) for k, v in host.items()})
            if g:
                w = self.lookup_window
                win = np.full((self.n_slots, w), self.pad_id, np.int64)
                wmask = np.zeros((self.n_slots, w), bool)
                for b, stream in enumerate(slots):  # prompt and tokens but the pending one
                    if stream is not None:
                        hist = (list(prompts[stream.idx]) + stream.tokens[:-1])[-w:]
                        if hist:
                            win[b, -len(hist):] = hist
                            wmask[b, -len(hist):] = True
                st.win, st.wmask = torch.tensor(win, device=dev), torch.tensor(wmask, device=dev)
            return st

        cursor = _bucket(max((len(p) for p in prompts), default=8))
        cache = init_cache(cfg, self.n_slots, dev)
        cache.length = cursor  # the host knows the cursor: nothing is read back for it
        state = upload()
        inflight: collections.deque = collections.deque()

        def plan_refill():
            groups: dict[int, list] = {}
            for b in range(self.n_slots):
                if slots[b] is None and queue:
                    idx = queue.popleft()
                    groups.setdefault(_bucket(len(prompts[idx])), []).append((b, idx))
            return sorted(groups.items())

        def finish_if_done(st: _Stream, b: int) -> None:
            if st.t_done is None and len(st.tokens) >= st.max_new:
                st.t_done = time.perf_counter()
                lat.append(st.t_done - st.t_submit)
                results[st.idx] = st.tokens[: st.max_new]
                if slots[b] is st:
                    slots[b] = None

        def process(entry) -> None:
            nonlocal spec_tokens, spec_waves
            # ``snap`` binds slots to streams as at dispatch: the live table
            # may already hold the next segment's refills
            pend, snap, fetch = entry
            toks, host["tok"], host["pos"], host["active"], host["rem"], *firsts_list = fetch.wait()
            if g:
                counts = firsts_list.pop()
                spec_tokens += int(counts.sum())
                spec_waves += int((counts > 0).sum())
            for members, firsts in zip(pend, firsts_list):
                for j, (b, _) in enumerate(members):
                    st = snap[b]
                    if int(firsts[j]) == self.eos:
                        st.max_new = 0
                    else:
                        st.tokens.append(int(firsts[j]))
                    finish_if_done(st, b)
            for b, st in enumerate(snap):
                if st is None or st.t_done is not None:
                    continue
                if g:
                    emitted = [t for w in range(toks.shape[1]) for t in toks[b, w, : int(counts[b, w])]]
                else:
                    emitted = toks[b]
                for t in emitted:
                    if len(st.tokens) >= st.max_new:
                        break
                    if int(t) == self.eos:
                        st.max_new = len(st.tokens)  # finished early
                        break
                    st.tokens.append(int(t))
                if not host["active"][b]:
                    st.max_new = min(st.max_new, len(st.tokens))
                finish_if_done(st, b)

        while any(s is not None for s in slots) or queue or inflight:
            if not (any(s is not None for s in slots) or queue):
                process(inflight.popleft())  # drain the tail
                continue
            if cursor + advance > cache.valid.shape[1]:
                while inflight:  # compaction needs the host's state exact: drain first
                    process(inflight.popleft())
                if not (any(s is not None for s in slots) or queue):
                    continue
                cache, cursor = self._compact(prompts, slots, _bucket(len(prompts[queue[0]])) if queue else 0)
                n_compact += 1
                if cursor + advance > cache.valid.shape[1]:
                    raise RuntimeError(budget_err)
                state = upload()
            pend, firsts = [], []
            for s_bucket, members in plan_refill():
                if cursor < s_bucket:
                    # a prompt bucket past the cursor: move it; the skipped rows stay invalid
                    if s_bucket + advance > cache.valid.shape[1]:
                        raise RuntimeError(budget_err)
                    cache.length = cursor = s_bucket
                for b, idx in members:
                    slots[b] = _Stream(idx=idx, tokens=[], max_new=limits[idx], t_submit=time.perf_counter())
                firsts.append(self._insert(cache, s_bucket, [(b, prompts[idx], limits[idx]) for b, idx in members],
                                           state))
                pend.append(members)
            counts = []
            if g:
                toks, spec_counts = self._decode_segment_spec(cache, state)
                counts = [spec_counts]
            else:
                toks = self._decode_segment(cache, state)
            cursor += advance
            inflight.append((pend, list(slots), _Fetch(
                [toks, state.tok, state.pos, state.active, state.rem, *firsts, *counts])))
            if len(inflight) >= 2:  # depth-2 pipeline: read segment N-1 while N runs
                process(inflight.popleft())
        wall = time.perf_counter() - t0
        total_tokens = sum(len(r) for r in results)
        stats = {
            "wall_s": wall,
            "total_tokens": total_tokens,
            "tokens_per_s": total_tokens / max(wall, 1e-9),
            "p50_latency_s": float(np.median(lat)) if lat else 0.0,
            "p95_latency_s": float(np.percentile(lat, 95)) if lat else 0.0,
            "compactions": n_compact,
        }
        if g:
            # mean tokens emitted per active wave: 1.0 = every draft rejected, gamma = all accepted
            stats["tokens_per_wave"] = spec_tokens / spec_waves if spec_waves else 0.0
        return results, stats
