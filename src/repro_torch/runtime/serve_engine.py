"""ServeEngine: continuous-batching request engine (port of
``repro/runtime/serve_engine.py``, single device).

  * a fixed batch of ``n_slots`` decode slots ticks together through one
    ``Model.decode_step`` with a per-slot ``pos`` vector and an ``active``
    mask; a finished request's slot is refilled on the next tick
    (``continuous=False``: only once every slot has drained);
  * full-attention KV families (dense, moe) keep one pool of
    ``block_size``-position blocks (``Model.paged_cache_specs``) addressed
    per slot through a block table; block 0 is the garbage target of
    inactive slots.  When the pool runs out, the youngest request is
    evicted and requeued with its generated prefix as prompt, which replays
    it exactly;
  * fixed-size caches (the hybrid family's conv windows and SSD states
    beside its shared-block KV) are one row per slot (``Model.cache_specs``
    with a per-slot ``pos``); admission splices the one-request prefill
    cache into the slot's row of every leaf;
  * prompts prefill in length buckets (``Model.prefill(lens=)``) and their
    blocks are copied into the pool; recurrent families (rwkv, hybrid)
    prefill at the prompt's exact length instead, because their state
    summarizes every position it sees, padding included;
  * sampling per request (``runtime/sampling.py``) with stop tokens,
    ``max_new_tokens`` and the capacity cap.

Each finished request appends a dict to ``records`` (arrival, admission,
first-token and done times on the engine clock, token counts, finish
reason, evictions).  Meshes and telemetry sinks are not ported yet
(ROADMAP.md).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.models.common import Spec, init_params
from repro_torch.models.model import Model
from repro_torch.runtime import serve_loop
from repro_torch.runtime.sampling import sample_tokens


@dataclasses.dataclass
class Request:
    """One generation request; ``arrival`` is seconds from the run start."""
    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    temperature: float = 0.0
    top_p: float = 1.0
    seed: int = 0
    stop_tokens: tuple[int, ...] = ()
    arrival: float = 0.0


@dataclasses.dataclass
class _Slot:
    req: Request | None = None
    pos: int = 0                # host mirror of the slot's cache pos
    next_token: int = 0         # token fed at the next decode tick
    blocks: list[int] = dataclasses.field(default_factory=list)
    admit_seq: int = 0


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _place_blocks(specs: dict, pool: dict, small: dict, targets: torch.Tensor,
                  block_size: int) -> None:
    """Copy a one-request prefill cache into the pool's physical blocks
    ``targets``, leaf by leaf over the (possibly nested) cache tree.  A
    leaf's block dim sits where its spec says "cache_blocks" (the moe family
    nests a second layer stack before it); the prefill leaf has its unit
    batch there, and its cache positions split into blocks."""
    for name, spec in specs.items():
        if isinstance(spec, dict):
            _place_blocks(spec, pool[name], small[name], targets, block_size)
            continue
        i = spec.axes.index("cache_blocks")
        sm = small[name].squeeze(i)
        sm = sm.reshape(*sm.shape[:i], len(targets), block_size, *sm.shape[i + 1:])
        pool[name][(slice(None),) * i + (targets,)] = sm.to(pool[name].dtype)


def _place_row(specs: dict, cache: dict, small: dict, slot: int) -> None:
    """Copy a one-request prefill cache into row ``slot`` of a slot-swap
    cache, leaf by leaf: a leaf's slot dim sits where its spec says
    "cache_batch" (after the layer stack dim)."""
    for name, spec in specs.items():
        if isinstance(spec, dict):
            _place_row(spec, cache[name], small[name], slot)
            continue
        i = spec.axes.index("cache_batch")
        cache[name][(slice(None),) * i + (slot,)] = small[name].squeeze(i).to(
            cache[name].dtype)


class ServeEngine:
    """See module docstring."""

    def __init__(self, model: Model, *, n_slots: int = 4, cache_len: int = 64,
                 block_size: int = 8, n_blocks: int | None = None,
                 continuous: bool = True):
        self.model, self.cfg = model, model.cfg
        self.device = model.device
        self.n_slots, self.cache_len = n_slots, cache_len
        self.continuous = continuous
        self.block_size = block_size
        self.paged = model.paged_cacheable
        # recurrent state summarizes every fed position, so padded prefill
        # would pollute it: these families prefill at the exact length
        self.exact_prefill = model.cfg.family in ("rwkv", "hybrid")
        if self.paged:
            self.max_blocks = cache_len // block_size + 1
            # default pool: worst case for every slot, +1 garbage block
            self.n_blocks = n_blocks or (1 + n_slots * self.max_blocks)
            self.cache_specs = model.paged_cache_specs(n_slots, self.n_blocks, block_size)
            self.free_blocks = list(range(self.n_blocks - 1, 0, -1))
            self.bt = np.zeros((n_slots, self.max_blocks), np.int32)
        else:
            # one cache row per slot; engine contract: pos is a per-slot vector
            self.cache_specs = model.cache_specs(n_slots, cache_len)
            self.cache_specs["pos"] = Spec((n_slots,), ("cache_batch",), init="zeros",
                                           dtype=torch.int32)
        self.cache = init_params(self.cache_specs, None, self.device,
                                 model.compute_dtype)
        # prefill lengths: powers of two from max(4, block_size), then cache_len
        b, buckets = max(4, block_size), []
        while b < cache_len:
            buckets.append(b)
            b *= 2
        self.prefill_buckets = tuple(buckets) + (cache_len,)
        self._decode = serve_loop.build_decode_step(model)
        self._prefills: dict[int, Callable] = {}

        self.slots = [_Slot() for _ in range(n_slots)]
        self.queue: collections.deque[Request] = collections.deque()
        self.results: dict[int, dict] = {}
        self.records: list[dict] = []
        self.temps = [0.0] * n_slots
        self.top_ps = [1.0] * n_slots
        self.seeds = [0] * n_slots
        self.steps = [0] * n_slots
        self._admit_seq = 0
        self._t0 = time.monotonic()
        self.n_ticks = 0
        self.n_prefills = 0
        self.n_evictions = 0
        # host seconds of prefill (+ first sample) and of decode ticks (+
        # sampling); sampling copies ids to the host, so both end synchronized
        self.prefill_s = self.decode_s = 0.0
        self.n_prefill_tokens = self.n_decode_tokens = 0

    @property
    def capacity(self) -> int:
        """Max total positions (prompt + generated) per request."""
        if not self.paged:
            return self.cache_len
        return min(self.cache_len, self.max_blocks * self.block_size - 1)

    def _now(self) -> float:
        return time.monotonic() - self._t0

    def _get_prefill(self, bucket: int) -> Callable:
        if bucket not in self._prefills:
            clen = _round_up(bucket, self.block_size) if self.paged else self.cache_len
            self._prefills[bucket] = serve_loop.build_prefill(self.model, clen,
                                                              with_lens=True)
        return self._prefills[bucket]

    def _bucket(self, length: int) -> int:
        for b in self.prefill_buckets:
            if b >= length:
                return b
        raise ValueError(f"prompt length {length} exceeds largest prefill "
                         f"bucket {self.prefill_buckets[-1]}")

    # ------------------------------------------------------------------
    # Request lifecycle
    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        if len(req.prompt) + req.max_new_tokens > self.capacity:
            raise ValueError(
                f"request {req.rid}: prompt {len(req.prompt)} + max_new "
                f"{req.max_new_tokens} exceeds capacity {self.capacity}")
        st = self.results.setdefault(req.rid, {
            "generated": [], "t_arrival": self._now(), "t_admit": None,
            "t_first_token": None, "t_done": None, "evictions": 0,
            "finish_reason": None,
        })
        if st["finish_reason"] is not None:
            raise ValueError(f"request {req.rid} already finished")
        self.queue.append(req)

    def _admit_ready(self) -> None:
        if not self.continuous and any(s.req for s in self.slots):
            return  # static batching: wait for the whole batch to drain
        free = [i for i, s in enumerate(self.slots) if s.req is None]
        while free and self.queue:
            req = self.queue[0]
            total = len(req.prompt) + len(self.results[req.rid]["generated"])
            if self.paged and len(self.free_blocks) < total // self.block_size + 1:
                # wait for in-flight requests to release blocks (evicting
                # here would thrash: the victim becomes the queue head)
                if not any(s.req is not None for s in self.slots):
                    raise RuntimeError(
                        f"request {req.rid} needs more blocks than the pool "
                        f"has free ({len(self.free_blocks)}) and nothing is "
                        "in flight to wait for")
                break
            self.queue.popleft()
            self._admit(free.pop(0), req)

    def _admit(self, slot_idx: int, req: Request) -> None:
        st = self.results[req.rid]
        gen = st["generated"]
        # an evicted request replays with its generated prefix as prompt;
        # its sampling keys continue at step len(gen)
        prompt = np.asarray(req.prompt, np.int32)
        if gen:
            prompt = np.concatenate([prompt, np.asarray(gen, np.int32)])
        L = len(prompt)
        bucket = L if self.exact_prefill else self._bucket(L)
        t0 = time.perf_counter()
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :L] = prompt
        logits, small = self._get_prefill(bucket)(
            {"tokens": torch.from_numpy(toks).to(self.device)},
            torch.tensor([L], dtype=torch.int32, device=self.device))
        self.n_prefills += 1

        slot = self.slots[slot_idx]
        if self.paged:
            n_keep = L // self.block_size + 1
            blocks = [self.free_blocks.pop() for _ in range(n_keep)]
            nb_bucket = _round_up(bucket, self.block_size) // self.block_size
            nb_real = min(n_keep, nb_bucket)
            targets = np.zeros(nb_bucket, np.int64)      # pad blocks -> garbage
            targets[:nb_real] = blocks[:nb_real]
            self.bt[slot_idx] = 0
            self.bt[slot_idx, :n_keep] = blocks
            _place_blocks(self.cache_specs["layers"], self.cache["layers"], small["layers"],
                          torch.from_numpy(targets).to(self.device), self.block_size)
            slot.blocks = blocks
        else:
            _place_row({k: v for k, v in self.cache_specs.items() if k != "pos"},
                       self.cache, small, slot_idx)
        self.cache["pos"][slot_idx] = L

        slot.req = req
        slot.pos = L
        slot.admit_seq = self._admit_seq
        self._admit_seq += 1
        self.temps[slot_idx] = req.temperature
        self.top_ps[slot_idx] = req.top_p
        self.seeds[slot_idx] = req.seed
        self.steps[slot_idx] = len(gen)
        if st["t_admit"] is None:
            st["t_admit"] = self._now()
        # the first token of this admission comes from the prefill logits
        tok = sample_tokens(logits, [req.temperature], [req.top_p], [req.seed],
                            [len(gen)])[0]
        self.prefill_s += time.perf_counter() - t0
        self.n_prefill_tokens += L
        self._take_token(slot_idx, tok)

    def _take_token(self, slot_idx: int, tok: int) -> None:
        slot = self.slots[slot_idx]
        req = slot.req
        st = self.results[req.rid]
        st["generated"].append(tok)
        self.steps[slot_idx] += 1
        if st["t_first_token"] is None:
            st["t_first_token"] = self._now()
        if tok in req.stop_tokens:
            self._finish(slot_idx, "stop_token")
        elif len(st["generated"]) >= req.max_new_tokens:
            self._finish(slot_idx, "max_new_tokens")
        elif slot.pos + 1 >= self.capacity:
            self._finish(slot_idx, "capacity")
        else:
            slot.next_token = tok

    def _finish(self, slot_idx: int, reason: str) -> None:
        slot = self.slots[slot_idx]
        req = slot.req
        st = self.results[req.rid]
        st["t_done"] = self._now()
        st["finish_reason"] = reason
        self.records.append({
            "rid": req.rid, "arch": self.cfg.name,
            "t_arrival": st["t_arrival"], "t_admit": st["t_admit"],
            "t_first_token": st["t_first_token"], "t_done": st["t_done"],
            "n_prompt": int(len(req.prompt)), "n_generated": len(st["generated"]),
            "finish_reason": reason, "evictions": st["evictions"],
        })
        self._release(slot_idx)

    def _release(self, slot_idx: int) -> None:
        slot = self.slots[slot_idx]
        if self.paged:
            self.free_blocks.extend(reversed(slot.blocks))
            self.bt[slot_idx] = 0
            slot.blocks = []
        slot.req = None
        slot.pos = 0
        slot.next_token = 0
        self.temps[slot_idx] = 0.0
        self.steps[slot_idx] = 0

    def _evict_one(self, exclude: int | None = None) -> bool:
        """Evict the youngest-admitted request and requeue it at the front
        with its generated prefix; False when nothing is evictable."""
        cands = [i for i, s in enumerate(self.slots)
                 if s.req is not None and i != exclude]
        if not cands:
            return False
        victim = max(cands, key=lambda i: self.slots[i].admit_seq)
        req = self.slots[victim].req
        self.results[req.rid]["evictions"] += 1
        self.n_evictions += 1
        self._release(victim)
        self.queue.appendleft(req)
        return True

    # ------------------------------------------------------------------
    # The tick
    # ------------------------------------------------------------------
    def _grow_blocks(self) -> None:
        """Give each slot whose next write crosses its allocation one more
        block; evict under pressure."""
        for i, slot in enumerate(self.slots):
            while (slot.req is not None
                   and slot.pos // self.block_size >= len(slot.blocks)):
                if not self.free_blocks:
                    if not self._evict_one(exclude=i):
                        raise RuntimeError("paged pool exhausted with nothing evictable")
                    continue
                blk = self.free_blocks.pop()
                self.bt[i, len(slot.blocks)] = blk
                slot.blocks.append(blk)

    def step(self) -> list[int]:
        """One tick: admissions, block growth, one decode step over the
        slot batch, sampling and stop handling.  Returns finished rids."""
        self._admit_ready()
        if not any(s.req is not None for s in self.slots):
            return []
        if self.paged:
            self._grow_blocks()
        active = [i for i, s in enumerate(self.slots) if s.req is not None]
        mask = np.zeros(self.n_slots, bool)
        mask[active] = True
        tokens = np.array([[s.next_token] for s in self.slots], np.int64)
        batch = {"token": torch.from_numpy(tokens).to(self.device),
                 "active": torch.from_numpy(mask).to(self.device)}
        if self.paged:
            batch["block_table"] = torch.from_numpy(self.bt).to(self.device)
        t0 = time.perf_counter()
        logits, self.cache = self._decode(self.cache, batch)
        sampled = sample_tokens(logits, self.temps, self.top_ps, self.seeds, self.steps)
        self.decode_s += time.perf_counter() - t0
        self.n_decode_tokens += len(active)
        self.n_ticks += 1
        finished = []
        for i in active:
            self.slots[i].pos += 1
            rid = self.slots[i].req.rid
            self._take_token(i, sampled[i])
            if self.slots[i].req is None:
                finished.append(rid)
        return finished

    def run(self, requests: list[Request] | None = None,
            max_ticks: int = 1_000_000) -> dict[int, np.ndarray]:
        """Admit ``requests`` as their arrival offsets pass on the engine
        clock and tick until everything drains; ``{rid: generated ids}``."""
        pending = sorted(requests or [], key=lambda r: (r.arrival, r.rid))
        self._t0 = time.monotonic()
        i = ticks = 0
        while (i < len(pending) or self.queue
               or any(s.req is not None for s in self.slots)):
            now = self._now()
            while i < len(pending) and pending[i].arrival <= now:
                self.submit(pending[i])
                i += 1
            if not self.queue and not any(s.req is not None for s in self.slots):
                wait = pending[i].arrival - self._now()
                if wait > 0:
                    time.sleep(min(wait, 0.01))
                continue
            self.step()
            ticks += 1
            if ticks > max_ticks:
                raise RuntimeError(f"engine did not drain in {max_ticks} ticks")
        return {rid: np.asarray(st["generated"], np.int32)
                for rid, st in self.results.items()}
