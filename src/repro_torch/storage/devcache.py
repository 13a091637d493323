"""Device-resident array caches: the HBM tier over the ``GraphStore``.

The port of the reference's ``storage/devcache.py``.  ``DeviceArrayCache``
is a fixed-capacity ``(C, W)`` entry cache (``table``) plus an ``entry id
-> slot`` indirection (``slot_of``, ``N+1`` entries, the last a scatter
sentinel), both tensors on the cache's ``device``, with host-managed,
batched admission: the LRU/pinned bookkeeping is vectorized numpy over
whole id batches (stamp arrays and ``argpartition`` victim selection;
under ``optimal``, a lexsort by the replayed next use, then the stamp).
Two instantiations:

* ``DeviceFeatureCache``: entries are feature rows; misses are fetched
  through the backing store (real paged reads over a ``DiskStore``) and
  the rows are gathered on the device by ``feature_gather_cached``.
* ``DeviceEdgeBlockCache``: entries are ``block_e``-wide int32 blocks of
  the padded edge array, read by ``neighbor_sample_cached``; ``plan``
  chunks a frontier so each dispatch's block set fits the LRU budget.

Residency contract: ids are resolved in segments whose non-pinned count
never exceeds the LRU capacity; hits are re-stamped before victims are
chosen, so every entry of a segment (or a planned sampling chunk) is
resident when it is dispatched.  Entries cross to the device with
unchanged bits, so cached training equals the full-upload path.

Admission is staged (``plan_rows`` -> ``fetch_plan`` -> ``execute_plan``)
exactly as in the reference, with every pad kept: the pads count toward
the LRU cut of ``_segments``, so they decide segments, evictions and the
per-batch counters.  The gathers themselves launch at each segment's own
length: the reference's padding of a launch to a power of two (jit's
static shapes) changes no row and no counter.  The reference's jitted ``_update`` becomes in-place
tensor scatters on the cache's device (``_push``), issued on the current
stream between the gathers, in plan order; on a GPU their host-to-device
copies go through the calling thread's ring of pinned buffers
(``PinnedStaging``), so an overlapped pipeline's lane copies on its own
stream without blocking.

Under the ``optimal`` (Belady) policy the victims are the resident
entries whose next use is farthest, from a schedule the replay lane
(``storage.oracle``) feeds through ``oracle_feed`` and each batch enters
with ``oracle_begin_batch``; with no schedule the choice is exact LRU.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.neighbor_sample import edge_block_count
from repro_torch.obs import names as obs_names
from repro_torch.storage.blockdev import FAR_NEXT_USE
from repro_torch.storage.specs import DEFAULT, DeviceCacheSpec


def pad_pow2(arr: np.ndarray, fill) -> np.ndarray:
    """Pad a 1-D/2-D array's leading dim up to the next power of two with
    ``fill`` rows (the reference's dispatch bucketing, kept because the
    pads decide the cache's segments and counters)."""
    n = arr.shape[0]
    width = 1 << (n - 1).bit_length()
    if width == n:
        return arr
    pad = np.broadcast_to(fill, (width - n,) + arr.shape[1:])
    return np.concatenate([arr, pad])


class PinnedStaging:
    """Host-to-device copies through a ring of pinned host buffers.

    ``copy(src, device)`` writes ``src`` into the next buffer of the ring
    and copies it to ``device`` with ``non_blocking=True`` on the calling
    thread's current stream, then records an event there.  A buffer is
    written again only after the event of its previous copy has
    completed, so a copy in flight never has its source overwritten, and
    the copy queues behind no other stream's work (a pageable copy would
    block the calling thread until it is done)."""

    def __init__(self, depth: int = 8):
        self._bufs: list[torch.Tensor | None] = [None] * depth
        self._events: list[torch.cuda.Event | None] = [None] * depth
        self._next = 0

    def copy(self, src: torch.Tensor, device) -> torch.Tensor:
        out = torch.empty(src.shape, dtype=src.dtype, device=device)
        nbytes = src.numel() * src.element_size()
        if nbytes == 0:
            return out
        k = self._next
        self._next = (k + 1) % len(self._bufs)
        event = self._events[k]
        if event is not None:
            event.synchronize()         # the buffer's last copy is done
        else:
            event = self._events[k] = torch.cuda.Event()
        buf = self._bufs[k]
        if buf is None or buf.numel() < nbytes:
            buf = self._bufs[k] = torch.empty(max(nbytes, 1 << 16),
                                              dtype=torch.uint8,
                                              pin_memory=True)
        staged = buf[:nbytes].view(src.dtype).view(src.shape)
        staged.copy_(src)
        out.copy_(staged, non_blocking=True)
        event.record(torch.cuda.current_stream(out.device))
        return out


_STAGING = threading.local()


def _to_device(arr: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device`` with unchanged bits.  To a GPU the copy
    goes through the calling thread's ``PinnedStaging`` ring, on its
    current stream; on the CPU it is a view."""
    src = torch.from_numpy(np.require(arr, requirements=("C", "W")))
    device = torch.device(device)
    if device.type != "cuda":
        return src.to(device)
    staging = getattr(_STAGING, "ring", None)
    if staging is None:
        staging = _STAGING.ring = PinnedStaging()
    return staging.copy(src, device)


@dataclasses.dataclass
class _PlanSegment:
    """One residency-contract segment of an ``AdmissionPlan``: the ids it
    serves, which of them miss, the victim slots reserved for the
    installs, and (after the fetch) the fetched payloads."""

    ids: np.ndarray                     # segment ids (dispatch pads incl.)
    miss_ids: np.ndarray
    slots: np.ndarray                   # install slots for miss_ids
    evict_ids: np.ndarray
    rows: np.ndarray | None = None      # miss payloads, set by the fetch
    hits: int = 0                       # counted-request counters
    misses: int = 0
    evictions: int = 0


@dataclasses.dataclass
class AdmissionPlan:
    """A batch's cache admission, decided but not yet performed:
    ``plan_rows`` makes it, ``fetch_plan`` fills its payloads,
    ``execute_plan``/``install_plan`` perform it.  ``counters`` is the
    plan's exact hit/miss/eviction/upload bill; ``generation`` pins it
    to the mirror state it was made against."""

    segments: list
    counters: dict
    generation: int = 0


class StaleAdmissionPlan(RuntimeError):
    """An ``AdmissionPlan`` outlived a cache ``reset()``."""


class DeviceArrayCache:
    """Generic device entry cache over one backing array, keyed by entry
    id.  Subclasses supply the geometry (``num_entries`` entries of
    ``width`` elements), a ``fetch(ids) -> (n, width)`` miss reader and a
    per-entry ``heat`` for pinned placement."""

    entry_noun = "entries"

    def __init__(self, *, array: str, num_entries: int, width: int,
                 dtype: torch.dtype, fetch, heat=None, capacity: int,
                 policy: str = "lru", pinned_fraction: float = 0.5,
                 device="cuda"):
        self.array = array
        self.capacity = int(capacity)
        self.policy = policy
        if self.policy not in ("lru", "pinned", "optimal"):
            raise ValueError(f"unknown device-cache policy {self.policy!r};"
                             " have ('lru', 'pinned', 'optimal')")
        if self.capacity < 1:
            raise ValueError(
                f"device {array} cache needs at least one {self.entry_noun}")
        n = int(num_entries)
        W = int(width)
        self.num_entries, self.width = n, W
        self.device = torch.device(device)
        self._fetch = fetch
        self._itemsize = torch.empty((), dtype=dtype).element_size()
        self._lock = threading.Lock()
        self.hits = self.misses = self.evictions = 0
        self.preload_rows = 0
        self.bytes_uploaded = 0
        self._generation = 0
        self.resets = 0

        if self.policy == "pinned":
            if self.capacity < 2:
                raise ValueError(
                    f"pinned policy needs capacity >= 2 {self.entry_noun} "
                    "(use policy='lru' for degenerate caches)")
            pin_budget = int(round(self.capacity * pinned_fraction))
            if pin_budget > self.capacity:
                raise ValueError(
                    f"pinned budget {pin_budget} exceeds cache capacity "
                    f"{self.capacity} {self.entry_noun}; pins are never "
                    "evicted, so shrink pinned_fraction or grow the cache")
            heat = np.asarray(heat if heat is not None else np.zeros(n))
            order = np.argsort(-heat, kind="stable")
            pinned_ids = np.sort(order[:min(pin_budget, n)]).astype(np.int64)
        else:
            pinned_ids = np.empty(0, np.int64)
        self._pinned_ids = pinned_ids
        self._pinned_mask = np.zeros(n + 1, bool)
        self._pinned_mask[pinned_ids] = True
        self._lru_capacity = self.capacity - pinned_ids.size
        if self._lru_capacity < 1:
            raise ValueError(
                f"pinned set ({pinned_ids.size} {self.entry_noun}) leaves "
                f"no LRU slots in a {self.capacity}-{self.entry_noun} "
                "cache; lower pinned_fraction or grow the cache")

        # vectorized host mirror: id -> slot, slot -> id/stamp/pinned
        self._host_slot = np.full(n + 1, -1, np.int64)
        self._slot_entry = np.full(self.capacity, -1, np.int64)
        self._slot_stamp = np.zeros(self.capacity, np.int64)
        self._slot_pinned = np.zeros(self.capacity, bool)
        self._free = np.arange(self.capacity)
        self._free_ptr = 0              # slots [_free_ptr:] still free
        self._clock = 0

        # Belady state (policy='optimal'): per-entry next-use times fed by
        # the replay lane, batch-granular; unscheduled entries sit at
        # FAR_NEXT_USE, the first victims
        if self.policy == "optimal":
            self._next_use = np.full(n + 1, FAR_NEXT_USE, np.int64)
            self._oracle_updates: dict[int, tuple] = {}
            self._oracle_pending: tuple | None = None

        # device state: index n of slot_of is the scatter-padding
        # sentinel, never queried by a real id
        self.slot_of = torch.full((n + 1,), -1, dtype=torch.int32,
                                  device=self.device)
        self.table = torch.zeros((self.capacity, W), dtype=dtype,
                                 device=self.device)
        if pinned_ids.size:
            self._preload_pinned()

    # -- admission / eviction (host-managed, batched) ------------------------
    def _preload_pinned(self) -> None:
        """Stage the pinned hot entries at construction.  The fetches are
        real backing reads but count as ``preload_rows``, not misses."""
        with self._lock:
            h, m, e = self.hits, self.misses, self.evictions
            self._resolve(self._pinned_ids)
            self._slot_pinned[self._host_slot[self._pinned_ids]] = True
            self.preload_rows += self.misses - m
            self.hits, self.misses, self.evictions = h, m, e

    def _segments(self, ids: np.ndarray):
        """Split ``ids`` (order preserved) so each segment's non-pinned
        count fits the LRU capacity: a segment's installs can then only
        evict entries outside the segment."""
        nonpinned = np.flatnonzero(~self._pinned_mask[ids])
        cuts = nonpinned[self._lru_capacity::self._lru_capacity]
        if cuts.size == 0:
            yield ids
            return
        yield from np.split(ids, cuts)

    def _plan_segment(self, seg: np.ndarray,
                      counted: int | None = None) -> _PlanSegment:
        """Decide residency for every id in ``seg`` in one batched pass
        of mirror bookkeeping: stamp hits at the MRU end, pick victim
        slots for all misses at once (free slots first, then the
        oldest-stamped non-pinned slots), and record the miss ids and
        reserved slots.  Only the first ``counted`` ids count toward the
        counters (the rest are dispatch filler).  Caller holds the
        lock."""
        if counted is None:
            counted = seg.size
        slots = self._host_slot[seg]
        hit_mask = slots >= 0
        hit_slots = slots[hit_mask]
        self._slot_stamp[hit_slots] = self._clock + np.arange(hit_slots.size)
        self._clock += int(hit_slots.size)
        # a repeated id installs once: only its first occurrence misses
        order = np.argsort(seg, kind="stable")
        dup = np.zeros(seg.size, bool)
        dup[order[1:]] = seg[order][1:] == seg[order][:-1]
        miss_mask = ~hit_mask & ~dup
        miss_ids = seg[miss_mask]
        n_hit = int(np.count_nonzero((hit_mask | (~hit_mask & dup))
                                     [:counted]))
        n_miss_counted = int(np.count_nonzero(miss_mask[:counted]))
        self.hits += n_hit
        self.misses += n_miss_counted
        ps = _PlanSegment(ids=seg, miss_ids=miss_ids,
                          slots=np.empty(0, np.int64),
                          evict_ids=np.empty(0, np.int64),
                          hits=n_hit, misses=n_miss_counted)
        m = int(miss_ids.size)
        if m == 0:
            return ps

        n_free = self.capacity - self._free_ptr
        take = min(n_free, m)
        new_slots = self._free[self._free_ptr:self._free_ptr + take]
        self._free_ptr += take
        n_evict = m - take
        if n_evict:
            if self.policy == "optimal":
                # Belady: the farthest next uses go first, the stamp
                # breaking ties (so with no schedule this is exact LRU);
                # the segment's hits must survive until its gather, and
                # the residency contract leaves enough other candidates
                cand = (self._slot_entry >= 0) & ~self._slot_pinned
                cand[hit_slots] = False
                occupied = np.flatnonzero(cand)
                nu = self._next_use[self._slot_entry[occupied]]
                order = np.lexsort((self._slot_stamp[occupied], -nu))
                oldest = occupied[order[:n_evict]]
            else:
                occupied = np.flatnonzero((self._slot_entry >= 0)
                                          & ~self._slot_pinned)
                oldest = occupied[np.argpartition(
                    self._slot_stamp[occupied], n_evict - 1)[:n_evict]]
            victims = self._slot_entry[oldest]
            self._host_slot[victims] = -1
            self._slot_entry[oldest] = -1
            new_slots = np.concatenate([new_slots, oldest])
            ps.evict_ids = victims
            # counted misses consume free slots first (they are a prefix
            # of the segment), so only their overflow displaces entries
            ps.evictions = min(n_evict, max(0, n_miss_counted - n_free))
            self.evictions += ps.evictions
        self._slot_stamp[new_slots] = self._clock + np.arange(m)
        self._clock += m
        self._host_slot[miss_ids] = new_slots
        self._slot_entry[new_slots] = miss_ids
        ps.slots = new_slots
        return ps

    def _fetch_segment(self, ps: _PlanSegment) -> None:
        """Pull a planned segment's miss payloads from the backing store;
        touches no cache state."""
        if ps.miss_ids.size:
            ps.rows = np.ascontiguousarray(self._fetch(ps.miss_ids))

    def _install_segment(self, ps: _PlanSegment) -> None:
        """Scatter a fetched segment into its reserved slots (device
        mutations replay in plan order)."""
        if ps.miss_ids.size:
            self._push(ps.miss_ids, ps.slots, ps.evict_ids, ps.rows)
            ps.rows = None              # free the host copy

    def _resolve(self, seg: np.ndarray, counted: int | None = None) -> None:
        """Make every id in ``seg`` resident: plan, fetch, install."""
        ps = self._plan_segment(seg, counted)
        self._fetch_segment(ps)
        self._install_segment(ps)

    def _push(self, miss_ids, miss_slots, evict_ids, rows) -> None:
        """Install the fetched entries and repair the indirection table,
        in place on the device: ``table[slots] = rows``, then
        ``slot_of[evict_ids] = -1``, then ``slot_of[new_ids] = slots``.
        Lengths are padded to powers of two as in the reference (pad rows
        rewrite the last slot with the last row, pad ids hit the sentinel
        entry), so ``slot_of`` ends in the reference's state."""
        m = len(miss_ids)
        width = 1 << (m - 1).bit_length()
        sent = self.num_entries
        slots = pad_pow2(np.asarray(miss_slots, np.int64), miss_slots[-1])
        new_ids = pad_pow2(np.asarray(miss_ids, np.int64), sent)
        ev = np.concatenate([np.asarray(evict_ids, np.int64),
                             np.full(width - len(evict_ids), sent, np.int64)])
        rows = pad_pow2(rows, rows[-1])
        dev = self.device
        slots_t = _to_device(slots, dev)
        self.table[slots_t] = _to_device(rows, dev).to(self.table.dtype)
        self.slot_of[_to_device(ev, dev)] = -1
        self.slot_of[_to_device(new_ids, dev)] = slots_t.to(torch.int32)
        self.bytes_uploaded += int(m) * self.width * self._itemsize

    # -- staged admission ----------------------------------------------------
    def plan_rows(self, ids: np.ndarray,
                  n_valid: int | None = None) -> AdmissionPlan:
        """Stage one: mirror bookkeeping for ``ids`` (segmented by the
        residency contract), under the lock, nothing fetched or uploaded
        yet.  Plans are made and executed in batch order.  ``n_valid``
        marks trailing ids as dispatch padding (excluded from the
        counters)."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        nv = ids.size if n_valid is None else int(n_valid)
        plan = AdmissionPlan(segments=[],
                             counters=dict.fromkeys(
                                 obs_names.DEVCACHE_KEYS, 0))
        offset = 0
        with self._lock:
            plan.generation = self._generation
            for seg in self._segments(ids):
                if seg.size == 0:
                    continue
                ps = self._plan_segment(seg, counted=max(
                    0, min(seg.size, nv - offset)))
                offset += seg.size
                plan.segments.append(ps)
                plan.counters["hits"] += ps.hits
                plan.counters["misses"] += ps.misses
                plan.counters["evictions"] += ps.evictions
                plan.counters["bytes_uploaded"] += (
                    int(ps.miss_ids.size) * self.width * self._itemsize)
        return plan

    def fetch_plan(self, plan: AdmissionPlan) -> AdmissionPlan:
        """Stage two: pull every planned segment's miss payloads from the
        backing store (lock-free, device-free)."""
        for ps in plan.segments:
            self._fetch_segment(ps)
        return plan

    def check_generation(self, plan: AdmissionPlan) -> None:
        """Refuse to install a plan made against a pre-``reset`` mirror."""
        if plan.generation != self._generation:
            raise StaleAdmissionPlan(
                f"device {self.array} cache: plan from generation "
                f"{plan.generation} cannot install into generation "
                f"{self._generation} (cache was reset)")

    def install_plan(self, plan: AdmissionPlan) -> None:
        """Stage three: scatter the fetched segments into their reserved
        slots, in plan order."""
        self.check_generation(plan)
        for ps in plan.segments:
            self._install_segment(ps)

    def reset(self, *, preload: bool = True) -> None:
        """Drop every entry and rebuild the mirror from scratch; bumps the
        generation so a surviving plan fails at install."""
        with self._lock:
            self._generation += 1
            self.resets += 1
            n = self.num_entries
            self._host_slot = np.full(n + 1, -1, np.int64)
            self._slot_entry = np.full(self.capacity, -1, np.int64)
            self._slot_stamp = np.zeros(self.capacity, np.int64)
            self._slot_pinned = np.zeros(self.capacity, bool)
            self._free = np.arange(self.capacity)
            self._free_ptr = 0
            self._clock = 0
            # stale table payloads are unreachable once slot_of is cleared
            self.slot_of.fill_(-1)
        if preload and self._pinned_ids.size:
            self._preload_pinned()

    # -- read paths ----------------------------------------------------------
    def resolve(self, ids: np.ndarray) -> None:
        """Admission without a gather: make ``ids`` resident (segmented by
        the residency contract).  The sampling kernel reads the entries
        through ``table``/``slot_of`` itself."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        with self._lock:
            for seg in self._segments(ids):
                if seg.size:
                    self._resolve(seg)

    # -- oracle (Belady) schedule delivery -----------------------------------
    def oracle_feed(self, updates: dict) -> None:
        """Accept per-batch next-use updates from the replay lane:
        ``{batch_idx: (entry_ids, next_use)}``, ``next_use[j]`` the first
        batch after ``batch_idx`` that requests ``entry_ids[j]`` again
        (``FAR_NEXT_USE`` if none inside the window).  Only under
        ``policy='optimal'``."""
        if self.policy != "optimal":
            raise ValueError(
                f"oracle_feed on a {self.policy!r}-policy device cache")
        with self._lock:
            self._oracle_updates.update(updates)

    def oracle_begin_batch(self, idx: int) -> None:
        """Enter batch ``idx`` (once per batch, in batch order, from the
        lane that plans this cache): the previous batch's deferred
        after-batch times land, then this batch's entries are protected
        at next-use == ``idx`` and their true times deferred to the next
        call.  A batch without a schedule (replay behind, or its update
        already popped before a restart) only lands the deferred times.
        The next-use mirror survives ``reset``."""
        if self.policy != "optimal":
            return
        with self._lock:
            if self._oracle_pending is not None:
                ids, nu = self._oracle_pending
                self._next_use[ids] = nu
                self._oracle_pending = None
            upd = self._oracle_updates.pop(idx, None)
            if upd is not None:
                ids, nu = upd
                self._next_use[ids] = idx
                self._oracle_pending = (ids, nu)

    # -- accounting ----------------------------------------------------------
    def counters(self) -> dict:
        with self._lock:
            return {k: getattr(self, k) for k in obs_names.DEVCACHE_KEYS}

    def stats(self) -> dict:
        return {"array": self.array, "policy": self.policy,
                "capacity_rows": self.capacity,
                "pinned_rows": int(self._pinned_ids.size),
                "resets": self.resets,
                **self.counters()}


class DeviceFeatureCache(DeviceArrayCache):
    """Device-resident hot-row cache over a ``GraphStore`` feature table.

    ``backing`` is anything with ``num_nodes`` / ``feat_dim`` /
    ``degrees()`` / ``gather_features(ids)``: a ``CSRGraph``, an
    ``InMemoryStore`` or a ``DiskStore`` (then every miss is a paged disk
    read).  Heat for the pinned policy is node degree."""

    entry_noun = "rows"

    def __init__(self, backing, *, rows: int | None = None,
                 policy: str | None = None,
                 pinned_fraction: float | None = None,
                 spec: DeviceCacheSpec = DEFAULT.devcache, device="cuda"):
        self.backing = backing
        n = int(backing.num_nodes)
        F = int(backing.feat_dim)
        self.num_nodes, self.feat_dim = n, F
        super().__init__(
            array="features", num_entries=n, width=F, dtype=torch.float32,
            fetch=lambda ids: np.ascontiguousarray(
                backing.gather_features(np.asarray(ids, np.int64)),
                np.float32),
            heat=backing.degrees(),
            capacity=int(spec.rows if rows is None else rows),
            policy=policy or spec.policy,
            pinned_fraction=(spec.pinned_fraction if pinned_fraction is None
                             else pinned_fraction),
            device=device)

    def execute_plan(self, plan: AdmissionPlan) -> torch.Tensor:
        """Install each fetched segment and gather it on the device,
        strictly in plan order: install(k) -> gather(k) -> install(k+1),
        so a later segment may evict an earlier one's rows only after
        their gather.  One ``feature_gather_cached`` launch per segment,
        at the segment's own length (the reference pads it to a power of
        two for jit's static shapes).  Returns (sum of segment lengths,
        F) float32."""
        self.check_generation(plan)
        parts = []
        for ps in plan.segments:
            self._install_segment(ps)
            parts.append(ops.feature_gather_cached(
                self.table, self.slot_of,
                _to_device(ps.ids.astype(np.int32), self.device)))
        if not parts:
            return torch.zeros((0, self.feat_dim), dtype=torch.float32,
                               device=self.device)
        return parts[0] if len(parts) == 1 else torch.cat(parts, 0)

    def gather_rows(self, ids: np.ndarray, n_valid: int | None = None
                    ) -> torch.Tensor:
        """ids: (U,) host node ids -> (U, F) float32 on the device,
        gathered through the cache, admitting misses along the way (any
        U, including U > capacity).  ``n_valid`` marks trailing ids as
        dispatch padding.  The synchronous composition of plan, fetch and
        execute."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        if ids.size == 0:
            return torch.zeros((0, self.feat_dim), dtype=torch.float32,
                               device=self.device)
        plan = self.plan_rows(ids, n_valid=n_valid)
        self.fetch_plan(plan)
        return self.execute_plan(plan)


class DeviceEdgeBlockCache(DeviceArrayCache):
    """Device-resident edge-block cache over the CSR topology.

    Entries are ``block_e``-wide int32 chunks of the padded ``indices``
    array (``edge_block_count``); the cached sampling kernel looks each
    block up through ``slot_of``, so the edge array never crosses to the
    device whole.  Block heat for the pinned policy is the largest degree
    of the nodes whose neighbour lists touch the block."""

    entry_noun = "blocks"

    def __init__(self, backing, *, indptr, block_e: int,
                 blocks: int, policy: str = "lru",
                 pinned_fraction: float = 0.5, device="cuda"):
        indptr = np.asarray(indptr, np.int64)
        self._indptr = indptr
        self.block_e = int(block_e)
        E = int(indptr[-1])
        nb = edge_block_count(E, self.block_e)
        self.num_blocks = nb
        # a degree-0 tail target's base block is clamped here, so the
        # pair (max_block, max_block+1) always exists
        self.max_block = nb - 2
        deg = np.diff(indptr)
        heat = np.zeros(nb, np.int64)
        if deg.size:
            b0 = np.minimum(indptr[:-1] // self.block_e, self.max_block)
            np.maximum.at(heat, b0, deg)
            np.maximum.at(heat, b0 + 1, deg)
        self.backing = backing
        super().__init__(
            array="topology", num_entries=nb, width=self.block_e,
            dtype=torch.int32,
            fetch=lambda ids: np.ascontiguousarray(
                backing.gather_edge_blocks(np.asarray(ids, np.int64),
                                           self.block_e), np.int32),
            heat=heat, capacity=int(blocks), policy=policy,
            pinned_fraction=pinned_fraction, device=device)
        if self._lru_capacity < 4:
            raise ValueError(
                f"edge-block cache needs >= 4 non-pinned blocks (one "
                f"target's block pair + the padding pair); got "
                f"{self._lru_capacity} of {self.capacity}; grow the cache "
                "or lower pinned_fraction")

    def plan(self, targets: np.ndarray) -> list[tuple[slice, np.ndarray]]:
        """Chunk a flat frontier so each dispatch's unique block working
        set fits the non-pinned budget.  Returns ``[(slice, block_ids),
        ...]``; every chunk's block list includes blocks (0, 1), which
        the padding targets (node 0) dereference."""
        t = np.asarray(targets, np.int64).reshape(-1)
        b0 = np.minimum(self._indptr[t] // self.block_e, self.max_block)
        budget = self._lru_capacity
        pinned = self._pinned_mask
        # the common case: the whole frontier's block set fits one dispatch
        needed = np.unique(np.concatenate([b0, b0 + 1, [0, 1]]))
        if np.count_nonzero(~pinned[needed]) <= budget:
            return [(slice(0, t.size), needed)]
        chunks: list[tuple[slice, np.ndarray]] = []

        def fresh() -> tuple[set, int]:
            blk = {0, 1}
            return blk, sum(1 for b in blk if not pinned[b])

        blk, used = fresh()
        cur = 0
        for k in range(t.size):
            pair = (int(b0[k]), int(b0[k]) + 1)
            need = [b for b in pair if b not in blk]
            cost = sum(1 for b in need if not pinned[b])
            if used + cost > budget and k > cur:
                chunks.append((slice(cur, k),
                               np.fromiter(sorted(blk), np.int64)))
                blk, used = fresh()
                cur = k
                need = [b for b in pair if b not in blk]
                cost = sum(1 for b in need if not pinned[b])
            blk.update(need)
            used += cost
        chunks.append((slice(cur, t.size),
                       np.fromiter(sorted(blk), np.int64)))
        return chunks
