"""Asynchronous data preparation: the host producers, prefetch and the
overlapped pipeline.

The port's copy of the reference's ``core/pipeline.py``.
``make_host_producer`` and ``ProducerConsumerPipeline`` are the host
backend's CPU data preparation (the paper's Fig. 4): producer threads
sample and gather numpy minibatches into a bounded set of results that
the consumer takes strictly in batch order, re-issuing a straggler's
batch to another worker.  ``PrefetchingLoader`` and ``OverlappedLoader``
wrap any loader: a background thread (prefetch) or one thread per stage
(overlap) prepares batches ahead of the consumer, which trains on batch
``t`` meanwhile; batches are pure functions of their index and every lane
runs them in index order, so the results are bit-equal to the
synchronous path.

On a GPU, which the reference (one JAX dispatch queue) never needed,
every lane that launches device work does so on a ``torch.cuda.Stream``
of its own, and what passes between lanes goes with a CUDA event:

* each lane's stream first waits on an event recorded on the consumer's
  stream when the lanes start, so the loader's uploads, cache preloads
  and resets are done before a lane reads them;
* after each stage the lane records an event on its stream and sends it
  with the payload; the receiving lane (and the consumer, in
  ``get_batch``) makes its own stream wait on that event before it runs,
  and marks every tensor of the payload as used on its stream
  (``record_stream``), so the allocator does not hand their memory out
  again while that stream may still read it;
* host-to-device copies go through pinned staging buffers on the lane's
  stream (``storage.devcache.PinnedStaging``).

A lane's error, a CUDA error included, is recorded and raised at the
consumer, as the reference raises a lane's exception.  A CPU run takes
none of these paths.

``OverlappedLoader(stall_inject=)`` schedules one sample-lane stall
(``FaultSpec.lane_stall``), which drives the watchdog's restart; after
it the lanes' new streams replay the batches in order, and an orphaned
lane's work lands in its dead generation.  With telemetry on, each
stage of each batch is a span on its lane's track (``overlap-sample``,
``overlap-resolve``, ``overlap-admit``): host time, which on a lane's
CUDA stream is the enqueue, not the device time.
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
import warnings

from typing import Callable

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.loader import Minibatch, batch_targets
from repro_torch.core.sampler import (DEFAULT_FANOUTS, _io_delta,
                                      _io_snapshot, sample_khop,
                                      saint_random_walk)
from repro_torch.obs.metrics import idle_fraction as _idle_fraction
from repro_torch.storage.store import nest_fault_counters


@dataclasses.dataclass
class PipelineStats:
    batches: int = 0
    consumer_idle_s: float = 0.0
    consumer_busy_s: float = 0.0
    produce_times: list = dataclasses.field(default_factory=list)
    reissued: int = 0
    duplicates_dropped: int = 0

    @property
    def idle_fraction(self) -> float:
        return _idle_fraction(self.consumer_idle_s, self.consumer_busy_s)


def make_host_producer(store, batch_size: int, fanouts=DEFAULT_FANOUTS,
                       *, seed: int = 0, sampler: str = "khop",
                       walk_length: int = 4,
                       storage_cost_fn=None) -> Callable[[int], Minibatch]:
    """Returns ``produce(batch_idx) -> Minibatch`` of numpy arrays.

    ``store`` is any GraphStore: a ``CSRGraph``, an ``InMemoryStore`` or
    a ``DiskStore``, where sampling and the feature and label gathers are
    paged reads and the batch's trace carries their measured block-I/O
    counters.  ``sampler`` is ``'khop'`` fanout expansion or ``'saint'``
    GraphSAINT walks of ``walk_length`` steps (one (M, L+1) hop tensor).
    An optimal-policy store rolls its Belady schedule forward before the
    batch's reads (``oracle_advance``).  The producer touches only numpy
    and the store.

    ``storage_cost_fn(trace) -> seconds`` (optional) models the storage
    tier serving the batch's access trace; the producer sleeps that long,
    so a slow simulated device shows as consumer idle time, as in the
    paper's Fig. 7.

    A store exposing ``sample_khop_pushdown`` (the in-storage processing
    service's ``RemoteGraphStore``) gets the whole k-hop sample and gather
    pushed down as one fused command: the storage process runs the
    expansion against its local blocks and replies with the sampled
    subgraph only, bit-identical to the host-side path at equal seeds,
    with the batch's storage-side I/O bill in the trace."""
    pushdown = getattr(store, "sample_khop_pushdown", None) \
        if sampler == "khop" else None

    def produce(batch_idx: int) -> Minibatch:
        adv = getattr(store, "oracle_advance", None)
        if adv is not None:
            adv(batch_idx)
        targets = batch_targets(store, batch_idx, batch_size, seed)
        if pushdown is not None:
            trace, hop_feats, labels = pushdown(targets, fanouts,
                                                seed=seed + batch_idx)
            if storage_cost_fn is not None:
                time.sleep(storage_cost_fn(trace))
            return Minibatch(targets=targets, hop_ids=list(trace.hops),
                             hop_feats=hop_feats, labels=labels,
                             trace=trace)
        io0 = _io_snapshot(store)
        if sampler == "saint":
            trace = saint_random_walk(store, targets, walk_length,
                                      seed=seed + batch_idx)
        else:
            trace = sample_khop(store, targets, fanouts,
                                seed=seed + batch_idx)
        hop_feats = [store.gather_features(h) for h in trace.hops]
        labels = store.gather_labels(targets)
        # the trace's span widens to the feature and label gathers; the
        # thread-scoped counters keep the per-batch delta exact
        trace.io = nest_fault_counters(_io_delta(store, io0))
        if storage_cost_fn is not None:
            time.sleep(storage_cost_fn(trace))
        return Minibatch(targets=targets, hop_ids=list(trace.hops),
                         hop_feats=hop_feats, labels=labels, trace=trace)

    return produce


class ProducerConsumerPipeline:
    """Bounded pipeline: ``n_workers`` producer threads and a
    caller-driven consumer.  ``produce_fn(batch_idx) -> batch``; batches
    are consumed strictly by index.  A batch not produced within
    ``straggler_factor`` times the recent mean production time is issued
    again to another worker and the first result wins; a request past the
    next index skips the batches in between; a producer's error is raised
    at the consumer."""

    def __init__(self, produce_fn: Callable[[int], object], *,
                 n_workers: int = 4, queue_depth: int = 8,
                 straggler_factor: float = 4.0):
        self.produce_fn = produce_fn
        self.n_workers = n_workers
        self.straggler_factor = straggler_factor
        self.stats = PipelineStats()
        self._tasks: queue.Queue = queue.Queue()
        self._results: dict[int, object] = {}
        self._errors: dict[int, BaseException] = {}
        self._results_lock = threading.Condition()
        self._issued: dict[int, float] = {}
        self._stop = threading.Event()
        self._queue_depth = queue_depth
        self._next_issue = 0
        self._watermark = 0          # lowest index still consumable
        self._threads = [
            threading.Thread(target=self._worker, daemon=True)
            for _ in range(n_workers)]
        for t in self._threads:
            t.start()

    # -- producer side -------------------------------------------------------
    def _worker(self):
        while not self._stop.is_set():
            try:
                idx = self._tasks.get(timeout=0.05)
            except queue.Empty:
                continue
            t0 = time.perf_counter()
            try:
                batch = self.produce_fn(idx)
            except BaseException as e:
                # wake the consumer now rather than at its timeout
                with self._results_lock:
                    self._errors[idx] = e
                    self._results_lock.notify_all()
                continue
            dt = time.perf_counter() - t0
            with self._results_lock:
                if idx < self._watermark:
                    # issued before a forward jump; never consumable
                    self.stats.duplicates_dropped += 1
                elif idx in self._results:
                    self.stats.duplicates_dropped += 1
                else:
                    self._results[idx] = batch
                    self.stats.produce_times.append(dt)
                self._results_lock.notify_all()

    def _ensure_issued(self, upto: int):
        # consumption is by increasing index, so a forward jump (first
        # request, resume, prefetch restart) makes the gap unconsumable:
        # skip it instead of producing it
        if upto > self._next_issue:
            self._next_issue = upto
            with self._results_lock:
                for k in [k for k in self._results if k < upto]:
                    del self._results[k]
                for k in [k for k in self._errors if k < upto]:
                    del self._errors[k]
        while self._next_issue <= upto + self._queue_depth - 1:
            self._tasks.put(self._next_issue)
            self._issued[self._next_issue] = time.perf_counter()
            self._next_issue += 1

    def _maybe_reissue(self, idx: int):
        times = self.stats.produce_times
        if len(times) < 2:
            return
        ewma = float(np.mean(times[-8:]))
        deadline = self.straggler_factor * max(ewma, 1e-4)
        if time.perf_counter() - self._issued.get(idx, 0) > deadline:
            self._tasks.put(idx)                      # re-issue; first wins
            self._issued[idx] = time.perf_counter()
            self.stats.reissued += 1

    # -- consumer side -------------------------------------------------------
    def get_batch(self, idx: int, timeout: float = 30.0):
        with self._results_lock:
            self._watermark = max(self._watermark, idx)
        self._ensure_issued(idx)
        t0 = time.perf_counter()
        with self._results_lock:
            while idx not in self._results:
                if idx in self._errors:
                    raise self._errors.pop(idx)
                self._results_lock.wait(timeout=0.02)
                self._maybe_reissue(idx)
                if time.perf_counter() - t0 > timeout:
                    raise TimeoutError(f"batch {idx} not produced")
            batch = self._results.pop(idx)
        self.stats.consumer_idle_s += time.perf_counter() - t0
        return batch

    def close(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=1.0)


# ---------------------------------------------------------------------------
# CUDA hand-offs between threads
# ---------------------------------------------------------------------------

def _cuda_device(inner) -> torch.device | None:
    """The GPU the wrapped loader prepares batches on, or None."""
    dev = getattr(inner, "device", None)
    if dev is None:
        return None
    dev = torch.device(dev)
    return dev if dev.type == "cuda" else None


def _tensors(obj):
    """Every tensor inside a payload (dicts, lists, tuples and dataclass
    instances are walked)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))


def _mark(device: torch.device | None) -> "torch.cuda.Event | None":
    """An event recorded on the calling thread's current stream: the work
    it queued so far (None on the CPU)."""
    if device is None:
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


def _receive(payload, event, device: torch.device | None) -> None:
    """Make the calling thread's current stream wait for ``event`` (the
    producer's work on ``payload``) and keep the payload's device
    tensors allocated until that stream is done with them."""
    if event is None:
        return
    stream = torch.cuda.current_stream(device)
    stream.wait_event(event)
    for t in _tensors(payload):
        if t.is_cuda:
            t.record_stream(stream)


def _lane_stream(device: torch.device | None, start):
    """Context for a lane thread: on a GPU, a new stream of its own that
    first waits for ``start``; on the CPU, nothing."""
    if device is None:
        return contextlib.nullcontext()
    stream = torch.cuda.Stream(device)
    stream.wait_event(start)
    return torch.cuda.stream(stream)


class PrefetchingLoader:
    """Asynchronous prefetch: overlap data preparation with training.

    Wraps any loader: one background worker thread runs
    ``inner.get_batch(i+1)`` (kernel launches included, on its own
    stream on a GPU) while the consumer trains on batch ``i``.  ``depth``
    is the bounded-queue capacity (``depth=2`` is double buffering).
    Production is single-worker and strictly ordered, so prefetched
    batches are bit-identical to synchronous ``get_batch`` calls.  A
    non-sequential request restarts the worker at the new index instead
    of draining through the gap."""

    def __init__(self, inner, depth: int = 2):
        self.inner = inner
        self.backend = getattr(inner, "backend", "?")
        self.fanouts = tuple(inner.fanouts)
        self.depth = max(1, int(depth))
        self._device = _cuda_device(inner)
        self._queue: queue.Queue = queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._expect: int | None = None
        self._prefetched = 0
        self._produce_times: list[float] = []
        self._restarts = 0

    # -- producer side -------------------------------------------------------
    def _worker(self, start: int, q: queue.Queue, stop: threading.Event,
                ready):
        # q/stop are captured per worker generation: a worker that outlives
        # a restart (join timeout mid-production) drains into its own dead
        # queue instead of corrupting the replacement's ordering
        idx = start
        with _lane_stream(self._device, ready):
            while not stop.is_set():
                t0 = time.perf_counter()
                try:
                    batch = self.inner.get_batch(idx)
                    item = (idx, batch, None, _mark(self._device))
                except BaseException as e:      # surfaced on the consumer
                    item = (idx, None, e, None)
                self._produce_times.append(time.perf_counter() - t0)
                while not stop.is_set():        # backpressure, abortable
                    try:
                        q.put(item, timeout=0.05)
                        break
                    except queue.Full:
                        continue
                if item[2] is not None:
                    return
                idx += 1

    def _restart(self, start: int):
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=5.0)
            self._restarts += 1
        # always a fresh queue: close() joins the worker but leaves its
        # prefetched items behind, and they must not leak into a restart
        self._queue = queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._worker,
            args=(start, self._queue, self._stop, _mark(self._device)),
            daemon=True, name="prefetch")
        self._thread.start()
        self._expect = start

    # -- consumer side -------------------------------------------------------
    def get_batch(self, idx: int, timeout: float = 60.0):
        if self._thread is None or idx != self._expect:
            self._restart(idx)
        t0 = time.perf_counter()
        while True:
            try:
                got, batch, err, event = self._queue.get(timeout=0.05)
                break
            except queue.Empty:
                if time.perf_counter() - t0 > timeout:
                    raise TimeoutError(f"batch {idx} not prefetched")
        if err is not None:
            self._expect = None                 # force a clean restart
            raise err
        if got != idx:
            raise RuntimeError(f"prefetch order violated: {got} != {idx}")
        _receive(batch, event, self._device)
        self._expect = idx + 1
        self._prefetched += 1
        return batch

    def start_epoch(self) -> None:
        """Forward the epoch boundary to the inner loader.  The worker may
        be up to ``depth`` batches ahead, so per-epoch counters include
        what it has already prefetched."""
        mark = getattr(self.inner, "start_epoch", None)
        if mark is not None:
            mark()

    def stats(self) -> dict:
        times = self._produce_times
        return dict(self.inner.stats(),
                    prefetch_depth=self.depth,
                    prefetched=self._prefetched,
                    prefetch_restarts=self._restarts,
                    mean_prefetch_s=(float(np.mean(times)) if times else 0.0))

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self.inner.close()


class OverlappedLoader:
    """Multi-stage overlapped out-of-core pipeline: compute, cache
    maintenance and I/O draining concurrently.

    Wraps a loader that exposes ``pipeline_stages()``: an ordered list of
    ``(name, fn)`` stages where stage 0 maps a batch index to a payload
    and each later stage maps the previous payload forward (the pallas
    out-of-core loader splits into sample -> resolve -> admit).  Each
    stage runs on its own thread with a bounded queue of ``stage_depth``
    between stages and ``depth`` at the output, so while the consumer
    trains on batch t, the admit lane uploads batch t+1's misses, the
    resolve lane reads batch t+2's misses from storage, and the sample
    lane draws batch t+3.  Loaders without ``pipeline_stages()`` run as a
    single produce stage (a ``PrefetchingLoader``).

    Bit-identity: every lane processes batches strictly in index order,
    cache plans are made serially in batch order, and device mutations
    replay in plan order on the admit lane, so values, cache counters and
    loss trajectories match the synchronous path.  (The host page cache
    is shared by the lanes: which batch's read of a block misses can
    change with their interleaving, never a value.)

    ``plan_ahead > 0`` runs the frontier planner in the sample lane:
    before drawing batch t, it calls ``inner.warm_batch(i)`` for every
    unwarmed index up to ``t + plan_ahead``.  Warms only populate the
    host page cache, so they cannot perturb bit-identity.

    Lane supervision: every lane keeps a heartbeat, refreshed at each
    loop turn, including while blocked on a bounded-queue put or get, so
    a stale beat means stuck inside a stage function.  A lane exception
    is recorded in a shared slot as well as forwarded through the
    queues, and the consumer checks the slot on every empty poll: a dead
    lane raises at the consumer within one poll tick.  When the consumer
    is starved and a heartbeat is older than ``lane_timeout`` seconds,
    the watchdog restarts the pipeline from the batch being waited on;
    stalls beyond ``max_lane_restarts`` degrade the loader permanently to
    synchronous composition (``inner.get_batch``) with a loud warning.
    Restarts and degradation call ``inner.reset_staged_state()`` so
    abandoned plans leave no ghost residency; a lane that survives a
    restart drains into its dead generation's queues, and its stale
    plans fail at install (``StaleAdmissionPlan``).

    ``stall_inject=(batch, seconds)`` schedules one deterministic
    sample-lane stall (chaos testing, from ``FaultSpec.lane_stall``)."""

    def __init__(self, inner, *, depth: int = 2, stage_depth: int = 2,
                 plan_ahead: int = 0, lane_timeout: float = 30.0,
                 max_lane_restarts: int = 3,
                 stall_inject: tuple[int, float] | None = None):
        self.inner = inner
        self.backend = getattr(inner, "backend", "?")
        self.fanouts = tuple(inner.fanouts)
        self.depth = max(1, int(depth))
        self.stage_depth = max(1, int(stage_depth))
        self.plan_ahead = max(0, int(plan_ahead))
        self.lane_timeout = float(lane_timeout)
        self.max_lane_restarts = int(max_lane_restarts)
        self._device = _cuda_device(inner)
        get_stages = getattr(inner, "pipeline_stages", None)
        stages = get_stages() if get_stages is not None else None
        if not stages:
            stages = [("produce", inner.get_batch)]
        self._stages = list(stages)
        self.stage_names = [name for name, _ in self._stages]
        self._warm = getattr(inner, "warm_batch", None)
        self._stage_s = {name: 0.0 for name in self.stage_names}
        self._stage_n = {name: 0 for name in self.stage_names}
        self._queues: list[queue.Queue] = []
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()
        self._expect: int | None = None
        self._prefetched = 0
        self._restarts = 0
        self._warmed = 0
        self._t_started: float | None = None
        self._t_stopped: float | None = None
        # supervision state
        self._gen = 0                      # lane generation (guards beats
        self._beat: dict[str, float] = {}  # ...and error reports from
        self._lane_error = None            # ...orphaned old lanes)
        self._lane_failures = 0
        self._lane_stall_restarts = 0
        self._degraded = False
        self._stall_inject = stall_inject
        self._stall_done = False

    # -- lanes ---------------------------------------------------------------
    def _beat_tick(self, gen: int, name: str) -> None:
        if gen == self._gen:
            self._beat[name] = time.perf_counter()

    def _note_error(self, gen: int, idx: int, e: BaseException) -> None:
        if gen == self._gen and self._lane_error is None:
            self._lane_error = (idx, e)

    def _put(self, q: queue.Queue, item, stop: threading.Event,
             gen: int, name: str) -> bool:
        while not stop.is_set():                # backpressure, abortable
            self._beat_tick(gen, name)          # blocked on put = healthy
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _source(self, start: int, qout: queue.Queue, stop: threading.Event,
                gen: int, ready):
        """Stage-0 lane: batch index -> first payload, plus the planner
        (page-cache warming for the plan-ahead window)."""
        name, fn = self._stages[0]
        idx = start
        warmed_to = start                       # warm [start, idx+1+W)
        with _lane_stream(self._device, ready):
            while not stop.is_set():
                self._beat_tick(gen, name)
                si = self._stall_inject
                if si is not None and idx == si[0] and not self._stall_done:
                    # flag first: the restart's replay must not stall again
                    self._stall_done = True
                    time.sleep(si[1])
                if self._warm is not None and self.plan_ahead:
                    while warmed_to < idx + 1 + self.plan_ahead:
                        try:
                            self._warmed += self._warm(warmed_to)
                        except Exception:       # advisory: never kill a lane
                            pass
                        warmed_to += 1
                t0 = time.perf_counter()
                try:
                    with obs.trace_span(name, batch=idx):
                        payload = fn(idx)
                    item = (idx, payload, None, _mark(self._device))
                except BaseException as e:      # surfaced on the consumer
                    item = (idx, None, e, None)
                    self._note_error(gen, idx, e)
                self._stage_s[name] += time.perf_counter() - t0
                self._stage_n[name] += 1
                if not self._put(qout, item, stop, gen, name) \
                        or item[2] is not None:
                    return
                idx += 1

    def _lane(self, k: int, qin: queue.Queue, qout: queue.Queue,
              stop: threading.Event, gen: int, ready):
        """Stage-k lane (k >= 1): previous payload -> next payload."""
        name, fn = self._stages[k]
        with _lane_stream(self._device, ready):
            while not stop.is_set():
                self._beat_tick(gen, name)
                try:
                    idx, payload, err, event = qin.get(timeout=0.05)
                except queue.Empty:
                    continue
                if err is None:
                    t0 = time.perf_counter()
                    try:
                        _receive(payload, event, self._device)
                        with obs.trace_span(name, batch=idx):
                            payload = fn(payload)
                        event = _mark(self._device)
                    except BaseException as e:
                        payload, err, event = None, e, None
                        self._note_error(gen, idx, e)
                    self._stage_s[name] += time.perf_counter() - t0
                    self._stage_n[name] += 1
                if not self._put(qout, (idx, payload, err, event), stop,
                                 gen, name) or err is not None:
                    return

    def _reset_inner(self) -> None:
        """Drop the inner loader's staged cache state: plans abandoned by
        the dying generation reserved cache-mirror slots whose device
        rows will never install (ghost residency).  The reset
        synchronizes the device, so any error of it raises at the
        consumer, on every device (the reference warns and goes on)."""
        reset = getattr(self.inner, "reset_staged_state", None)
        if reset is not None:
            reset()

    def _restart(self, start: int):
        if self._threads:
            self._stop.set()
            self._gen += 1          # orphans' beats/errors no longer count
            self._lane_error = None
            for t in self._threads:
                t.join(timeout=5.0)
            self._restarts += 1
            self._reset_inner()
        # fresh queues per generation: a lane that outlives a restart
        # (join timeout mid-production) drains into its own dead queues
        # instead of corrupting the replacement's ordering
        n = len(self._stages)
        self._queues = [queue.Queue(maxsize=self.stage_depth)
                        for _ in range(n - 1)]
        self._queues.append(queue.Queue(maxsize=self.depth))
        self._stop = threading.Event()
        gen = self._gen
        ready = _mark(self._device)     # the consumer's work so far
        now = time.perf_counter()
        self._beat = {name: now for name in self.stage_names}
        self._threads = [threading.Thread(
            target=self._source,
            args=(start, self._queues[0], self._stop, gen, ready),
            daemon=True, name="overlap-" + self.stage_names[0])]
        for k in range(1, n):
            self._threads.append(threading.Thread(
                target=self._lane,
                args=(k, self._queues[k - 1], self._queues[k], self._stop,
                      gen, ready),
                daemon=True, name="overlap-" + self.stage_names[k]))
        for t in self._threads:
            t.start()
        self._expect = start
        if self._t_started is None:
            self._t_started = time.perf_counter()

    def _degrade(self) -> None:
        """Permanent fallback to synchronous composition: stop feeding the
        lanes and serve every future batch via ``inner.get_batch`` on the
        consumer thread.  Values are unaffected (the sync path composes
        the same stage functions); only the overlap is lost."""
        warnings.warn(
            f"overlapped pipeline: lanes stalled beyond the restart budget "
            f"(max_lane_restarts={self.max_lane_restarts}); degrading "
            "permanently to synchronous composition; training continues "
            "without overlap", stacklevel=3)
        self._degraded = True
        self._gen += 1
        self._lane_error = None
        self._stop.set()                # orphans are daemons; let them die
        self._threads = []
        self._reset_inner()
        if self._t_started is not None and self._t_stopped is None:
            self._t_stopped = time.perf_counter()

    # -- consumer side -------------------------------------------------------
    def get_batch(self, idx: int, timeout: float = 60.0):
        if self._degraded:
            return self.inner.get_batch(idx)
        if not self._threads or idx != self._expect:
            self._restart(idx)
        t0 = time.perf_counter()
        out = self._queues[-1]
        while True:
            try:
                got, batch, err, event = out.get(timeout=0.05)
                break
            except queue.Empty:
                le = self._lane_error
                if le is not None and le[0] <= idx:
                    # the lane died at or before the batch waited for, and
                    # its poison item may be stuck behind a full queue:
                    # raise from the shared slot now; the next request's
                    # restart discards the dead generation's queues
                    self._lane_error = None
                    self._expect = None
                    self._lane_failures += 1
                    raise le[1]
                now = time.perf_counter()
                stalled = [name for name, b in self._beat.items()
                           if now - b > self.lane_timeout]
                if stalled:
                    self._lane_stall_restarts += 1
                    if self._lane_stall_restarts > self.max_lane_restarts:
                        self._degrade()
                        return self.inner.get_batch(idx)
                    warnings.warn(
                        f"overlapped pipeline: lane(s) {stalled} missed "
                        f"their heartbeat for > {self.lane_timeout}s; "
                        f"restarting from batch {idx} (deterministic "
                        "replay)", stacklevel=2)
                    self._restart(idx)
                    out = self._queues[-1]
                    t0 = time.perf_counter()
                    continue
                if now - t0 > timeout:
                    raise TimeoutError(f"batch {idx} not produced by the "
                                       "overlapped pipeline")
        if err is not None:
            self._lane_error = None
            self._expect = None                 # force a clean restart
            self._lane_failures += 1
            raise err
        if got != idx:
            raise RuntimeError(f"overlap order violated: {got} != {idx}")
        _receive(batch, event, self._device)
        self._expect = idx + 1
        self._prefetched += 1
        return batch

    def start_epoch(self) -> None:
        """Forward the epoch boundary (same pipeline-depth caveat as
        ``PrefetchingLoader.start_epoch``)."""
        mark = getattr(self.inner, "start_epoch", None)
        if mark is not None:
            mark()

    def stats(self) -> dict:
        wall = 0.0
        if self._t_started is not None:
            end = self._t_stopped if self._t_stopped is not None \
                else time.perf_counter()
            wall = end - self._t_started
        stage_s = dict(self._stage_s)
        busy = sum(stage_s.values())
        return dict(self.inner.stats(),
                    prefetch_depth=self.depth,
                    stage_depth=self.stage_depth,
                    plan_ahead=self.plan_ahead,
                    prefetched=self._prefetched,
                    prefetch_restarts=self._restarts,
                    stages=list(self.stage_names),
                    stage_s=stage_s,
                    stage_mean_s={k: v / max(self._stage_n[k], 1)
                                  for k, v in stage_s.items()},
                    planner_warm_ranges=self._warmed,
                    pipeline_wall_s=wall,
                    # > 1.0 iff the lanes actually ran concurrently
                    overlap_factor=(busy / wall if wall > 0 else 0.0),
                    lane_timeout=self.lane_timeout,
                    lane_failures=self._lane_failures,
                    lane_stall_restarts=self._lane_stall_restarts,
                    degraded=self._degraded)

    def close(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads = []
        if self._t_started is not None and self._t_stopped is None:
            self._t_stopped = time.perf_counter()
        self.inner.close()
