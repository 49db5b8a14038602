"""ServeEngine: continuous-batching request engine (port of
``repro/runtime/serve_engine.py``).

  * a fixed batch of ``n_slots`` decode slots ticks together through one
    ``Model.decode_step`` with a per-slot ``pos`` vector and an ``active``
    mask; a finished request's slot is refilled on the next tick
    (``continuous=False``: only once every slot has drained);
  * full-attention KV families (dense, moe, encdec, vlm) keep one pool of
    ``block_size``-position blocks (``Model.paged_cache_specs``) addressed
    per slot through a block table; block 0 is the garbage target of
    inactive slots.  When the pool runs out, the youngest request is
    evicted and requeued with its generated prefix as prompt, which replays
    it exactly;
  * fixed-size caches (a sliding window's KV ring; the hybrid family's
    conv windows and SSD states beside its shared-block KV; rwkv's state)
    are one row per slot (``Model.cache_specs`` with a per-slot ``pos``);
    admission splices the one-request prefill cache into the slot's row of
    every leaf.  An int8 KV cache (``kv_quant``) carries its scale leaves
    through both;
  * prompts prefill in length buckets (``Model.prefill(lens=)``, which
    places a ring by each prompt's true length) and their blocks are
    copied into the pool; recurrent families (rwkv, hybrid) prefill at the
    prompt's exact length instead, because their state summarizes every
    position it sees, padding included;
  * sampling per request (``runtime/sampling.py``) with stop tokens,
    ``max_new_tokens`` and the capacity cap;
  * the encdec family's requests carry their ``frames`` in
    ``Request.extras``: they enter the admission prefill, whose encoding
    (the reference encodes a second time for the slot; the port keeps
    prefill's) is written into the slot's row of an fp32 ``memory`` of
    (n_slots, enc_seq_len, d) that every tick feeds to the decode step;
  * the vlm family's requests carry their ``patches`` (num_patches,
    frontend_dim) in ``Request.extras`` into the admission prefill, whose
    ``num_patches`` positions come before the prompt's in the slot's blocks
    (``patch_off``): the capacity, the admission's block count, the
    prefill's cache length and the slot's ``pos`` count them too.

Each finished request appends a ``repro.telemetry/1`` ``request`` record to
``records`` (arrival, admission, first-token and done times on the engine
clock, token counts, finish reason, evictions), validated by
``core/telemetry.py``, and writes it to ``telemetry_sink`` if given.

``mesh`` / ``plan`` (a dp-only ``ParallelPlan``: ZeRO 0, no tp, pp or ep;
any family but encdec, which raises) serve data-parallel slots on
``torch.distributed`` (``serve_loop.build_decode_step``): data rank r holds the cache rows of
slots [r n/dp, (r + 1) n/dp) or its n_blocks/dp blocks of the pool (its own
garbage block 0 first); ``owner`` is the one place that says so.  Every
rank keeps the whole request book (the same queue, slots, block tables and
per-rank free lists), runs the decode tick on its rows and gathers the
tick's logits over the data group, so every rank samples the same tokens.
For the books to stay the same, ``run`` admits on data rank 0's clock: each
loop rank 0 broadcasts how many pending requests have arrived, and every
rank submits that many (a caller driving ``submit``/``step`` itself submits
the same requests on every rank).  A request's admission prefill runs on
the rank that owns its slot alone, which broadcasts the (1, V) logits to
the others (``serve_loop.share_logits``).  The weights are the model's,
replicated.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import telemetry as tel
from repro_torch.models.common import Spec, init_params, spec_tree_map
from repro_torch.models.model import Model
from repro_torch.runtime import serve_loop
from repro_torch.runtime.sampling import sample_tokens


@dataclasses.dataclass
class Request:
    """One generation request; ``arrival`` is seconds from the run start;
    ``extras`` the non-token prefill inputs (``frames`` (T, frontend_dim)
    for encdec, ``patches`` (num_patches, frontend_dim) for vlm)."""
    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    temperature: float = 0.0
    top_p: float = 1.0
    seed: int = 0
    stop_tokens: tuple[int, ...] = ()
    arrival: float = 0.0
    extras: dict | None = None


@dataclasses.dataclass
class _Slot:
    req: Request | None = None
    pos: int = 0                # host mirror of the slot's cache pos (vlm: + patches)
    next_token: int = 0         # token fed at the next decode tick
    blocks: list[int] = dataclasses.field(default_factory=list)
    admit_seq: int = 0


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _rank_share(specs: dict, dp: int) -> dict:
    """The Spec tree of one data rank's cache: each leaf's slot dim
    ("cache_batch") or pool block dim ("cache_blocks") divided by ``dp``."""
    def share(s: Spec) -> Spec:
        shape = tuple(n // dp if a in ("cache_batch", "cache_blocks") else n
                      for n, a in zip(s.shape, s.axes))
        return Spec(shape, s.axes, s.init, s.scale, s.dtype)
    return spec_tree_map(share, specs)


def _place_blocks(specs: dict, pool: dict, small: dict, targets: torch.Tensor,
                  block_size: int) -> None:
    """Copy a one-request prefill cache into the pool's physical blocks
    ``targets``, leaf by leaf over the (possibly nested) cache tree, an int8
    pool's scale leaves included.  A leaf's block dim sits where its spec
    says "cache_blocks" (the moe family nests a second layer stack before
    it); the prefill leaf has its unit batch there, and its cache positions
    split into blocks."""
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
    cache, leaf by leaf (scale leaves included): a leaf's slot dim sits
    where its spec says "cache_batch" (after the layer stack dim)."""
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
                 continuous: bool = True, mesh: Any = None, plan: Any = None,
                 telemetry_sink: Any = None):
        self.model, self.cfg = model, model.cfg
        self.device = model.device
        self.n_slots, self.cache_len = n_slots, cache_len
        self.continuous = continuous
        self.block_size = block_size
        self.sink = telemetry_sink
        self.paged = model.paged_cacheable
        # the vlm family's patch positions ahead of every prompt
        self.patch_off = model.patch_offset
        # recurrent state summarizes every fed position, so padded prefill
        # would pollute it: these families prefill at the exact length
        self.exact_prefill = model.cfg.family in ("rwkv", "hybrid")
        if mesh is not None and model.cfg.family == "encdec":
            raise NotImplementedError("dp serving of the encdec family (each rank's slots' "
                                      "memory) is not ported yet (see ROADMAP.md, Queue 1)")
        self.mesh = None if mesh is None else serve_loop.serve_mesh(model, mesh, plan)
        self.dp = 1 if self.mesh is None else self.mesh.sizes["data"]
        self.rank = 0 if self.mesh is None else self.mesh.coord["data"]
        if n_slots % self.dp:
            raise ValueError(f"{n_slots} slots do not split over dp={self.dp}")
        self.rank_slots = n_slots // self.dp
        if self.paged:
            self.max_blocks = (cache_len + self.patch_off) // block_size + 1
            # default pool: worst case for every slot, +1 garbage block a rank
            self.n_blocks = n_blocks or self.dp * (1 + self.rank_slots * self.max_blocks)
            if self.n_blocks % self.dp:
                raise ValueError(f"a pool of {self.n_blocks} blocks does not split over "
                                 f"dp={self.dp}")
            self.cache_specs = model.paged_cache_specs(n_slots, self.n_blocks, block_size)
            # each data rank's free blocks (ids into its own pool)
            rank_blocks = self.n_blocks // self.dp
            self.free_blocks = [list(range(rank_blocks - 1, 0, -1)) for _ in range(self.dp)]
            self.bt = np.zeros((n_slots, self.max_blocks), np.int32)
        else:
            self.max_blocks = None
            # one cache row per slot; engine contract: pos is a per-slot vector
            self.cache_specs = model.cache_specs(n_slots, cache_len)
            self.cache_specs["pos"] = Spec((n_slots,), ("cache_batch",), init="zeros",
                                           dtype=torch.int32)
        rows = slice(self.rank * self.rank_slots, (self.rank + 1) * self.rank_slots)
        self._decode = serve_loop.build_decode_step(model, self.mesh, rows)
        self.cache = init_params(_rank_share(self.cache_specs, self.dp), None, self.device,
                                 model.compute_dtype)
        # prefill lengths: powers of two from max(4, block_size), then cache_len
        b, buckets = max(4, block_size), []
        while b < cache_len:
            buckets.append(b)
            b *= 2
        self.prefill_buckets = tuple(buckets) + (cache_len,)
        self._prefills: dict[int, Callable] = {}
        self.memory = None
        if model.cfg.family == "encdec":
            self.memory = torch.zeros((n_slots, model.cfg.enc_seq_len, model.cfg.d_model),
                                      dtype=torch.float32, device=self.device)

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

    def owner(self, slot_idx: int) -> int:
        """The data rank that holds slot ``slot_idx``'s cache (and draws its
        blocks from its own share of the pool)."""
        return slot_idx // self.rank_slots

    @property
    def capacity(self) -> int:
        """Max total positions (prompt + generated + patches) per request."""
        cap = self.cache_len + self.patch_off
        if not self.paged:
            return cap
        return min(cap, self.max_blocks * self.block_size - 1)

    def _now(self) -> float:
        return time.monotonic() - self._t0

    def _get_prefill(self, bucket: int) -> Callable:
        if bucket not in self._prefills:
            clen = (_round_up(bucket + self.patch_off, self.block_size) if self.paged
                    else self.cache_len)
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
        if len(req.prompt) + req.max_new_tokens + self.patch_off > self.capacity:
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
            slot = free[0]
            if self.paged:
                total = (len(req.prompt) + self.patch_off
                         + len(self.results[req.rid]["generated"]))
                need = total // self.block_size + 1
                fits = [i for i in free if len(self.free_blocks[self.owner(i)]) >= need]
                if not fits:
                    # wait for in-flight requests to release blocks (evicting
                    # here would thrash: the victim becomes the queue head)
                    if not any(s.req is not None for s in self.slots):
                        raise RuntimeError(
                            f"request {req.rid} needs {need} blocks, more than a pool has "
                            "free, and nothing is in flight to wait for")
                    break
                slot = fits[0]
            self.queue.popleft()
            free.remove(slot)
            self._admit(slot, req)

    def _admit(self, slot_idx: int, req: Request) -> None:
        st = self.results[req.rid]
        gen = st["generated"]
        # an evicted request replays with its generated prefix as prompt;
        # its sampling keys continue at step len(gen)
        prompt = np.asarray(req.prompt, np.int32)
        if gen:
            prompt = np.concatenate([prompt, np.asarray(gen, np.int32)])
        L = len(prompt)
        total = L + self.patch_off           # the positions the prefill writes
        bucket = L if self.exact_prefill else self._bucket(L)
        t0 = time.perf_counter()
        owner = self.owner(slot_idx)
        local = slot_idx - owner * self.rank_slots
        slot = self.slots[slot_idx]
        if self.paged:
            n_keep = total // self.block_size + 1
            blocks = [self.free_blocks[owner].pop() for _ in range(n_keep)]
            self.bt[slot_idx] = 0
            self.bt[slot_idx, :n_keep] = blocks
            slot.blocks = blocks
        logits = None
        if owner == self.rank:
            toks = np.zeros((1, bucket), np.int64)
            toks[0, :L] = prompt
            batch = {"tokens": torch.from_numpy(toks).to(self.device)}
            for k, v in (req.extras or {}).items():
                batch[k] = torch.as_tensor(np.asarray(v))[None].to(self.device)
            logits, small = self._get_prefill(bucket)(
                batch, torch.tensor([L], dtype=torch.int32, device=self.device))
            if self.memory is not None:
                self.memory[slot_idx] = small["memory"][0]
            if self.paged:
                nb_bucket = _round_up(bucket + self.patch_off,
                                      self.block_size) // self.block_size
                nb_real = min(n_keep, nb_bucket)
                targets = np.zeros(nb_bucket, np.int64)      # pad blocks -> garbage
                targets[:nb_real] = blocks[:nb_real]
                _place_blocks(self.cache_specs["layers"], self.cache["layers"],
                              small["layers"], torch.from_numpy(targets).to(self.device),
                              self.block_size)
            else:
                _place_row({k: v for k, v in self.cache_specs.items() if k != "pos"},
                           self.cache, small, local)
            self.cache["pos"][local] = total
        if self.mesh is not None:
            logits = serve_loop.share_logits(logits, owner, self.mesh, self.cfg.vocab_size,
                                             self.device)
        self.n_prefills += 1

        slot.req = req
        slot.pos = total
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
        st = self.results[slot.req.rid]
        st["t_done"] = self._now()
        st["finish_reason"] = reason
        self._emit_record(slot.req, st)
        self._release(slot_idx)

    def _emit_record(self, req: Request, st: dict) -> None:
        """The request's ``request`` record (``repro/runtime/serve_engine.py:
        _emit_record``), validated, kept in ``records`` and written to the
        sink."""
        rec = tel.sanitize_record({
            "schema": tel.SCHEMA, "kind": "request", "rid": req.rid,
            "arch": self.cfg.name,
            "t_arrival": st["t_arrival"], "t_admit": st["t_admit"],
            "t_first_token": st["t_first_token"], "t_done": st["t_done"],
            "n_prompt": int(len(req.prompt)), "n_generated": len(st["generated"]),
            "finish_reason": st["finish_reason"], "evictions": st["evictions"],
        })
        tel.validate_record(rec)
        self.records.append(rec)
        if self.sink is not None:
            self.sink.write(rec)

    def _release(self, slot_idx: int) -> None:
        slot = self.slots[slot_idx]
        if self.paged:
            self.free_blocks[self.owner(slot_idx)].extend(reversed(slot.blocks))
            self.bt[slot_idx] = 0
            slot.blocks = []
        slot.req = None
        slot.pos = 0
        slot.next_token = 0
        self.temps[slot_idx] = 0.0
        self.steps[slot_idx] = 0

    def _evict_one(self, exclude: int) -> bool:
        """Evict the youngest-admitted request of ``exclude``'s data rank
        (whose pool ran out) but ``exclude`` itself and requeue it at the
        front with its generated prefix; False when nothing is evictable."""
        rank = self.owner(exclude)
        cands = [i for i, s in enumerate(self.slots)
                 if s.req is not None and i != exclude and self.owner(i) == rank]
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
            free = self.free_blocks[self.owner(i)]
            while (slot.req is not None
                   and slot.pos // self.block_size >= len(slot.blocks)):
                if not free:
                    if not self._evict_one(exclude=i):
                        raise RuntimeError("paged pool exhausted with nothing evictable")
                    continue
                blk = free.pop()
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
        if self.memory is not None:
            batch["memory"] = self.memory
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

    def _n_arrived(self, pending: list[Request], i: int) -> int:
        """How many of ``pending[i:]`` have arrived on the engine clock; under
        a mesh data rank 0's count, so that every rank submits the same
        requests before the same tick."""
        now, n = self._now(), 0
        while i + n < len(pending) and pending[i + n].arrival <= now:
            n += 1
        if self.mesh is not None:
            n = serve_loop.data_rank0_int(n, self.mesh, self.device)
        return n

    def run(self, requests: list[Request] | None = None,
            max_ticks: int = 1_000_000) -> dict[int, np.ndarray]:
        """Admit ``requests`` as their arrival offsets pass on the engine
        clock and tick until everything drains; ``{rid: generated ids}``."""
        pending = sorted(requests or [], key=lambda r: (r.arrival, r.rid))
        self._t0 = time.monotonic()
        i = ticks = 0
        while (i < len(pending) or self.queue
               or any(s.req is not None for s in self.slots)):
            if i < len(pending):
                n = self._n_arrived(pending, i)
                for req in pending[i:i + n]:
                    self.submit(req)
                i += n
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
