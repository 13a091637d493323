"""The port's in-storage processing service (``repro_torch.isp``) against
the reference's ``repro.isp``, on the CPU.

The reference's ``tests/test_isp_service.py``, case for case, on the port
(its three direct-I/O tests are mirrored in ``test_torch_faults.py``):
frame round trips and the decoder's refusals, the three transports, the
client's in-flight window matched by request id, reconnect-and-replay, a
dead server and a storage-side error classified, the pushdown
bit-identical to host sampling, the minibatch stream over memory, disk
and the isp store bit-identical, a training run through a spawned server
repr-equal to host@disk with the server exiting 0, a ``kill -9`` of the
server surfacing a ``StoreReadError`` within 60 s, and the spec surface.
Then what only a port needs: frames encoded by either package are the
same bytes and decode in the other; a port client works against a
reference server and a reference client against a port server; on
``smoke_pallas_isp`` the minibatch stream and the wire bytes equal the
reference's at seed 0; and the pallas backend's device caches over the
isp store give the local store's batches.  Ids, features, labels, bytes
and counters are held bit for bit and losses repr-equal; there is no
tolerance in this file.
"""

import os
import struct
import threading
import time
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.core.config as ref_config
from repro.core import load_dataset as jload_dataset
from repro.isp import client as ref_client
from repro.isp import protocol as ref_protocol
from repro.isp import server as ref_server
from repro_torch.core import (GNNConfig, GraphSAGE, build_pipeline,
                              build_train_step, load_dataset, sample_khop,
                              train_loop)
from repro_torch.core import config as port_config
from repro_torch.core.config import (BackendSpec, CacheTierSpec, IspSpec,
                                     PipelineSpec, PrefetchSpec, SamplerSpec,
                                     StoreSpec)
from repro_torch.isp import protocol, transport
from repro_torch.isp.client import IspClient, RemoteGraphStore
from repro_torch.isp.protocol import Command
from repro_torch.isp.server import IspServer, spawn_server
from repro_torch.optim import adamw
from repro_torch.storage import DiskStore, save_graph
from repro_torch.storage.store import StoreReadError

SPEC_DIR = Path(__file__).resolve().parent.parent / "benchmarks" / "specs"


@pytest.fixture(scope="module")
def small_graph():
    return load_dataset("reddit")


@pytest.fixture(scope="module")
def disk_dir(small_graph, tmp_path_factory):
    path = tmp_path_factory.mktemp("ispstore")
    save_graph(small_graph, str(path))
    return str(path)


def _recv_from(buf: bytes):
    """A ``recv_exact`` over an in-memory byte string (raises
    ``TransportClosed`` at EOF, like a socket would)."""
    view = memoryview(buf)
    pos = [0]

    def recv_exact(n: int):
        if pos[0] + n > len(buf):
            raise transport.TransportClosed("eof")
        out = view[pos[0]:pos[0] + n]
        pos[0] += n
        return out

    return recv_exact


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------

_DTYPES = ("<i4", "<i8", "<f4", "<f8", "|u1", "<u2")


def _frame_inputs(dtypes, shape_seed):
    rng = np.random.default_rng(shape_seed)
    arrays = []
    for dt in dtypes:
        shape = tuple(int(s) for s in
                      rng.integers(0, 5, size=int(rng.integers(0, 4))))
        arrays.append((rng.integers(0, 100, size=shape) * 3)
                      .astype(np.dtype(dt)))
    return arrays


@given(st.lists(st.sampled_from(_DTYPES), min_size=0, max_size=4),
       st.integers(min_value=0, max_value=2**32 - 1),
       st.integers(min_value=0, max_value=10_000),
       st.sampled_from([False, True]))
@settings(max_examples=30, deadline=None)
def test_frame_roundtrip(dtypes, rid, shape_seed, payload_crc):
    """Any (dtype, shape) mix survives encode -> read_message exactly:
    values, dtypes, shapes, meta, request id, and the reported wire size."""
    arrays = _frame_inputs(dtypes, shape_seed)
    meta = {"fanouts": [3, 2], "seed": int(rid % 7), "nested": {"k": "v"}}
    frame = protocol.encode(Command.SAMPLE_KHOP, rid, meta, arrays,
                            payload_crc=payload_crc)
    msg, nbytes = protocol.read_message(_recv_from(frame))
    assert nbytes == len(frame)
    assert msg.command == Command.SAMPLE_KHOP
    assert msg.request_id == rid
    assert msg.meta == meta
    assert not msg.is_reply and not msg.is_error
    assert len(msg.arrays) == len(arrays)
    for got, want in zip(msg.arrays, arrays):
        assert got.dtype == want.dtype
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@given(st.lists(st.sampled_from(_DTYPES), min_size=0, max_size=4),
       st.integers(min_value=0, max_value=2**32 - 1),
       st.integers(min_value=0, max_value=10_000),
       st.sampled_from([False, True]),
       st.sampled_from([0, protocol.FLAG_REPLY,
                        protocol.FLAG_REPLY | protocol.FLAG_ERROR]))
@settings(max_examples=30, deadline=None)
def test_frames_byte_equal_to_reference(dtypes, rid, shape_seed,
                                        payload_crc, flags):
    """Both packages encode the same frame, byte for byte, and each
    decodes the other's."""
    arrays = _frame_inputs(dtypes, shape_seed)
    meta = {"fanouts": [25, 10], "seed": int(rid % 11), "io": {"hits": 3}}
    assert protocol.HEADER_BYTES == ref_protocol.HEADER_BYTES
    assert {c.name: int(c) for c in Command} == \
        {c.name: int(c) for c in ref_protocol.Command}
    mine = protocol.encode(Command.GATHER_FEATURES, rid, meta, arrays,
                           flags=flags, payload_crc=payload_crc)
    theirs = ref_protocol.encode(ref_protocol.Command.GATHER_FEATURES, rid,
                                 meta, arrays, flags=flags,
                                 payload_crc=payload_crc)
    assert mine == theirs
    for read, frame in ((ref_protocol.read_message, mine),
                        (protocol.read_message, theirs)):
        msg, nbytes = read(_recv_from(frame))
        assert nbytes == len(frame)
        assert (msg.command, msg.request_id, msg.meta, msg.flags) == (
            int(Command.GATHER_FEATURES), rid, meta,
            flags | (protocol.FLAG_PAYLOAD_CRC if payload_crc else 0))
        for got, want in zip(msg.arrays, arrays):
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)


def test_reply_and_error_flags_roundtrip():
    frame = protocol.encode(Command.STATS, 7, {"error": "boom"}, [],
                            flags=protocol.FLAG_REPLY | protocol.FLAG_ERROR)
    msg, _ = protocol.read_message(_recv_from(frame))
    assert msg.is_reply and msg.is_error


def test_truncated_stream_is_transport_closed():
    """A peer dying mid-frame is a transport condition, not a decode bug."""
    frame = protocol.encode(Command.HELLO, 1, {}, [np.arange(10)])
    for cut in (0, 10, protocol.HEADER_BYTES, len(frame) - 1):
        with pytest.raises(transport.TransportClosed):
            protocol.read_message(_recv_from(frame[:cut]))


def _pack_header(magic=protocol.MAGIC, version=protocol.VERSION, command=1,
                 flags=0, rid=0, meta_len=0, payload_len=0, crc=None):
    head = protocol._HEADER.pack(magic, version, command, flags, rid,
                                 meta_len, payload_len, 0)
    if crc is None:
        from repro_torch.storage.integrity import crc32c
        crc = crc32c(head[:-4])
    return head[:-4] + struct.pack("<I", crc)


def test_garbage_header_rejected():
    with pytest.raises(protocol.ProtocolError, match="truncated header"):
        protocol._parse_header(b"short")
    with pytest.raises(protocol.ProtocolError, match="bad magic"):
        protocol.read_message(_recv_from(_pack_header(magic=0xDEADBEEF)))
    with pytest.raises(protocol.ProtocolError, match="version"):
        protocol.read_message(_recv_from(_pack_header(version=99)))
    with pytest.raises(protocol.ProtocolError, match="CRC32C mismatch"):
        protocol.read_message(_recv_from(_pack_header(crc=0)))
    with pytest.raises(protocol.ProtocolError, match="meta length"):
        protocol.read_message(_recv_from(
            _pack_header(meta_len=protocol.MAX_META_BYTES + 1)))
    with pytest.raises(protocol.ProtocolError, match="payload length"):
        protocol.read_message(_recv_from(
            _pack_header(payload_len=protocol.MAX_PAYLOAD_BYTES + 1)))


def test_flipped_bit_in_header_rejected():
    """Any single corrupted header byte fails the CRC (or an earlier
    field check), never decoding into a trusted length."""
    frame = protocol.encode(Command.HELLO, 3, {"a": 1}, [np.arange(4)])
    for i in range(protocol.HEADER_BYTES):
        bad = bytearray(frame)
        bad[i] ^= 0x40
        with pytest.raises(protocol.ProtocolError):
            protocol.read_message(_recv_from(bytes(bad)))


def test_payload_crc_detects_corruption():
    arr = np.arange(1024, dtype=np.int64)
    frame = protocol.encode(Command.GATHER_FEATURES, 1, {}, [arr],
                            payload_crc=True)
    bad = bytearray(frame)
    bad[-5] ^= 0x01
    with pytest.raises(protocol.ProtocolError, match="payload CRC"):
        protocol.read_message(_recv_from(bytes(bad)))
    msg, _ = protocol.read_message(_recv_from(frame))
    np.testing.assert_array_equal(msg.arrays[0], arr)


def test_descriptor_payload_length_mismatch_rejected():
    """Descriptors claiming more bytes than the payload holds are
    rejected before any allocation is trusted."""
    frame = protocol.encode(Command.HELLO, 1, {},
                            [np.arange(8, dtype=np.int32)])     # 32 B payload
    head = _pack_header(command=int(Command.HELLO), meta_len=len(frame) -
                        protocol.HEADER_BYTES - 32, payload_len=16)
    with pytest.raises(protocol.ProtocolError, match="payload too short"):
        protocol.read_message(_recv_from(head + frame[protocol.HEADER_BYTES:]))


# ---------------------------------------------------------------------------
# transports
# ---------------------------------------------------------------------------

def _echo_once(listener, n_messages=1):
    """Accept one connection and echo ``n_messages`` frames back as
    replies."""

    def run():
        conn = listener.accept(timeout=10.0)
        try:
            for _ in range(n_messages):
                msg, _ = protocol.read_message(conn.recv_exact)
                conn.send_bytes(protocol.encode(
                    msg.command, msg.request_id, {"echo": msg.meta},
                    msg.arrays, flags=protocol.FLAG_REPLY))
        finally:
            conn.close()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


@pytest.mark.parametrize("kind", ["unix", "tcp", "shm"])
def test_transport_roundtrip(kind, tmp_path):
    if kind == "unix":
        address = os.path.join(str(tmp_path), "t.sock")
    elif kind == "tcp":
        address = "127.0.0.1:0"
    else:
        address = f"isp-ttest-{os.getpid():x}-{int(time.time() * 1e6):x}"
    listener = transport.make_listener(kind, address)
    address = getattr(listener, "address", address)
    n = 4       # several frames so the shm ring wraps its cursors
    t = _echo_once(listener, n_messages=n)
    conn = transport.connect(kind, address, timeout=10.0)
    try:
        for i in range(n):
            arr = np.arange(100_000 + i, dtype=np.int64)
            conn.send_bytes(protocol.encode(Command.GATHER_FEATURES, i,
                                            {"i": i}, [arr]))
            msg, _ = protocol.read_message(conn.recv_exact)
            assert msg.is_reply and msg.request_id == i
            assert msg.meta == {"echo": {"i": i}}
            np.testing.assert_array_equal(msg.arrays[0], arr)
    finally:
        conn.close()
        t.join(timeout=10.0)
        listener.close()
    assert not t.is_alive()


# ---------------------------------------------------------------------------
# client window + reconnect against an in-process server
# ---------------------------------------------------------------------------

class _Loopback:
    """A real ``IspServer`` over a unix socket in a daemon thread, with
    the same accept-again-after-drop loop as ``run_server``."""

    def __init__(self, store, tmp, **server_kw):
        self.address = os.path.join(str(tmp), "isp.sock")
        self.listener = transport.make_listener("unix", self.address)
        self.server = IspServer(store, **server_kw)
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        while True:
            try:
                conn = self.listener.accept(timeout=10.0)
            except (TimeoutError, OSError):
                return
            if self.server.serve_connection(conn):
                return

    def close(self):
        self.thread.join(timeout=10.0)
        self.listener.close()


@pytest.fixture()
def loopback(disk_dir, tmp_path):
    store = DiskStore(disk_dir, cache_mb=2.0)
    lb = _Loopback(store, tmp_path)
    yield lb
    lb.close()
    store.close()


def test_window_pipelines_and_matches_by_request_id(small_graph, loopback):
    """Fill the in-flight window, then wait out of submission order:
    every reply carries its own request's rows (matched by id, not by
    arrival order); then 12 threads share the window without a
    deadlock."""
    client = IspClient("unix", loopback.address, window=4)
    try:
        batches = [np.arange(i * 7, i * 7 + 5, dtype=np.int64)
                   % small_graph.num_nodes for i in range(4)]
        pending = [client.submit(Command.GATHER_FEATURES, None, [ids])
                   for ids in batches]
        for ids, p in reversed(list(zip(batches, pending))):
            msg = client.wait(p)
            np.testing.assert_array_equal(
                msg.arrays[0], small_graph.features[ids])
        errs = []

        def producer(w):
            try:
                ids = np.arange(w, w + 9, dtype=np.int64) \
                    % small_graph.num_nodes
                msg = client.call(Command.GATHER_FEATURES, None, [ids])
                np.testing.assert_array_equal(
                    msg.arrays[0], small_graph.features[ids])
            except Exception as e:      # noqa: BLE001
                errs.append(e)

        threads = [threading.Thread(target=producer, args=(w,))
                   for w in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30.0)
        assert not any(t.is_alive() for t in threads)
        assert not errs
        assert client.counters["requests"] >= 16
        assert client.counters["bytes_tx"] > 0
        assert client.counters["bytes_rx"] > 0
        client.call(Command.SHUTDOWN)
    finally:
        client.close()


def test_reconnect_and_replay_after_transient_drop(small_graph, loopback):
    """A severed connection heals: the next call reconnects and replays,
    with the drop and the reconnect both on the books."""
    client = IspClient("unix", loopback.address, window=2,
                       connect_timeout=5.0)
    store = RemoteGraphStore(client)
    try:
        ids = np.arange(16, dtype=np.int64)
        np.testing.assert_array_equal(store.gather_features(ids),
                                      small_graph.features[ids])
        client.drop_connection()
        time.sleep(0.1)     # let the reader notice the dead socket
        np.testing.assert_array_equal(store.gather_features(ids),
                                      small_graph.features[ids])
        assert client.counters["disconnects"] >= 1
        assert client.counters["reconnects"] >= 1
        trace, _, _ = store.sample_khop_pushdown(
            np.arange(8, dtype=np.int32), (3, 2), seed=0)
        ref = sample_khop(small_graph, np.arange(8, dtype=np.int32), (3, 2),
                          seed=0)
        for h, r in zip(trace.hops, ref.hops):
            np.testing.assert_array_equal(h, r)
    finally:
        store.close()


def test_dead_server_is_classified_not_a_hang(loopback):
    """After SHUTDOWN the server is gone for good: the next call raises
    ``RemoteStoreError``, a ``StoreReadError``, within bounded time."""
    client = IspClient("unix", loopback.address, window=2,
                       connect_timeout=1.0, call_timeout=10.0)
    store = RemoteGraphStore(client)
    client.call(Command.SHUTDOWN)
    t0 = time.monotonic()
    with pytest.raises(StoreReadError):
        for _ in range(3):      # first calls may still drain the socket
            store.gather_features(np.arange(4, dtype=np.int64))
            time.sleep(0.05)
    assert time.monotonic() - t0 < 30.0
    assert client.counters["disconnects"] >= 1
    client.close()


def test_server_side_error_is_classified(loopback):
    """A storage-side failure travels back as a FLAG_ERROR reply with the
    exception class, not a dead connection."""
    client = IspClient("unix", loopback.address, window=2)
    try:
        with pytest.raises(RuntimeError):
            client.call(Command.GATHER_FEATURES, None,
                        [np.array([10**9], dtype=np.int64)])
        msg = client.call(Command.STATS)
        assert msg.meta["server"]["requests"] >= 2
        client.call(Command.SHUTDOWN)
    finally:
        client.close()


# ---------------------------------------------------------------------------
# pushdown bit-identity + the spawned-subprocess path
# ---------------------------------------------------------------------------

def _isp_spec(batch_size=8, seed=0, **store_kw):
    return PipelineSpec(
        backend=BackendSpec(name="host", n_workers=1, queue_depth=2),
        sampler=SamplerSpec(family="khop", fanouts=(3, 2)),
        store=StoreSpec(kind="disk", mode="isp", **store_kw),
        cache_tiers=(CacheTierSpec(tier="host", policy="lru",
                                   capacity_mb=4.0, arrays=()),),
        batch_size=batch_size, seed=seed)


def test_pushdown_bit_identical_to_host_sampling(small_graph, loopback):
    """The fused SAMPLE_KHOP equals host-side sample and gather exactly,
    for several seeds: hops, subgraph, per-hop features, labels."""
    client = IspClient("unix", loopback.address, window=4)
    store = RemoteGraphStore(client)
    try:
        g = small_graph
        for seed in (0, 1, 17):
            targets = np.random.default_rng(seed).integers(
                0, g.num_nodes, 8).astype(np.int32)
            trace, hop_feats, labels = store.sample_khop_pushdown(
                targets, (3, 2), seed=seed)
            ref = sample_khop(g, targets, (3, 2), seed=seed)
            assert len(trace.hops) == len(ref.hops)
            for h, r in zip(trace.hops, ref.hops):
                np.testing.assert_array_equal(h, r)
            np.testing.assert_array_equal(trace.subgraph_nodes,
                                          ref.subgraph_nodes)
            np.testing.assert_array_equal(trace.touched_nodes,
                                          ref.touched_nodes)
            for h, f in zip(ref.hops, hop_feats):
                np.testing.assert_array_equal(f, g.features[h])
            np.testing.assert_array_equal(labels, g.labels[targets])
        assert trace.io.get("requests", 0) > 0      # server-side I/O bill
    finally:
        store.close()


def _assert_same_batch(x, y):
    np.testing.assert_array_equal(np.asarray(x.targets),
                                  np.asarray(y.targets))
    np.testing.assert_array_equal(np.asarray(x.labels),
                                  np.asarray(y.labels))
    for hx, hy in zip(x.hop_ids, y.hop_ids):
        np.testing.assert_array_equal(np.asarray(hx), np.asarray(hy))
    for fx, fy in zip(x.hop_feats, y.hop_feats):
        np.testing.assert_array_equal(np.asarray(fx), np.asarray(fy))


def test_minibatch_stream_bit_identical_mem_disk_isp(small_graph, tmp_path):
    """The full loader stack: host@mem, host@disk and isp (a spawned
    storage process) give byte-identical minibatches."""
    g = small_graph

    def batches(spec, n=3):
        with build_pipeline(spec, g, device="cpu") as pipe:
            return [pipe.loader.get_batch(i) for i in range(n)]

    base = dict(
        backend=BackendSpec(name="host", n_workers=1, queue_depth=2),
        sampler=SamplerSpec(family="khop", fanouts=(3, 2)),
        batch_size=8, seed=0)
    tiers = (CacheTierSpec(tier="host", policy="lru", capacity_mb=4.0,
                           arrays=()),)
    mem = batches(PipelineSpec(store=StoreSpec(kind="mem"), **base))
    disk = batches(PipelineSpec(
        store=StoreSpec(kind="disk", path=str(tmp_path / "d")),
        cache_tiers=tiers, **base))
    isp = batches(PipelineSpec(
        store=StoreSpec(kind="disk", mode="isp", path=str(tmp_path / "i")),
        cache_tiers=tiers, **base))
    for a, b in ((mem, disk), (mem, isp)):
        for x, y in zip(a, b):
            _assert_same_batch(x, y)


def _train(spec, g, steps=4):
    with build_pipeline(spec, g, device="cpu") as pipe:
        gnn = GraphSAGE(GNNConfig(feat_dim=g.feat_dim, hidden=16,
                                  n_classes=int(g.labels.max()) + 1,
                                  fanouts=spec.effective_fanouts),
                        device="cpu")
        opt = adamw(1e-3)
        step = build_train_step(pipe, gnn, opt)
        state = {"opt": opt.init(dict(gnn.named_parameters())), "step": 0}
        losses = []
        train_loop(pipe, step, state, steps=steps,
                   on_step=lambda i, s, m: losses.append(
                       repr(float(m["loss"]))))
        stats = pipe.stats()
        proc = getattr(pipe.store, "server_proc", None)
    return losses, stats, proc


def test_loss_trajectory_bit_identical_isp_vs_host(small_graph, tmp_path):
    """4 training steps through a spawned storage process: losses
    repr-equal to host@disk's, nonzero wire counters, no disconnect, and
    the server reaped with exit 0."""
    base = dict(
        backend=BackendSpec(name="host", n_workers=1, queue_depth=2),
        sampler=SamplerSpec(family="khop", fanouts=(3, 2)),
        cache_tiers=(CacheTierSpec(tier="host", policy="lru",
                                   capacity_mb=4.0, arrays=()),),
        batch_size=8, seed=0)
    host_losses, _, _ = _train(PipelineSpec(
        store=StoreSpec(kind="disk", path=str(tmp_path / "host")), **base),
        small_graph)
    isp_losses, isp_stats, proc = _train(PipelineSpec(
        store=StoreSpec(kind="disk", mode="isp",
                        path=str(tmp_path / "isp")), **base), small_graph)
    assert isp_losses == host_losses
    st = isp_stats["store"]
    assert st["kind"] == "isp"
    assert st["isp"]["bytes_tx"] > 0 and st["isp"]["bytes_rx"] > 0
    assert st["isp"]["disconnects"] == 0
    assert proc is not None and proc.poll() == 0    # reaped, exit 0


def test_server_crash_mid_epoch_surfaces_classified(small_graph, tmp_path):
    """``kill -9`` of the storage process mid-epoch: the loader raises a
    classified ``StoreReadError`` within 60 s, not a hang, with the
    disconnect counted."""
    spec = _isp_spec(path=str(tmp_path / "crash"))
    pipe = build_pipeline(spec, small_graph, device="cpu")
    try:
        pipe.loader.get_batch(0)            # healthy batch first
        proc = pipe.store.server_proc
        proc.kill()
        proc.wait(timeout=10.0)
        t0 = time.monotonic()
        with pytest.raises(StoreReadError):
            for i in range(1, 8):
                pipe.loader.get_batch(i)
        assert time.monotonic() - t0 < 60.0
        assert pipe.store.isp_counters()["disconnects"] >= 1
    finally:
        pipe.close()


# ---------------------------------------------------------------------------
# spec surface
# ---------------------------------------------------------------------------

def test_isp_spec_validation():
    with pytest.raises(ValueError, match="mode"):
        StoreSpec(kind="mem", mode="isp")
    with pytest.raises(ValueError, match="transport"):
        IspSpec(transport="carrier-pigeon")
    with pytest.raises(ValueError, match="window"):
        IspSpec(window=0)
    assert StoreSpec(kind="disk").isp is None
    assert StoreSpec(kind="disk", mode="isp").isp == IspSpec()


def test_isp_mode_rejects_optimal_and_isp_backend():
    tiers = (CacheTierSpec(tier="host", policy="optimal", capacity_mb=2.0,
                           arrays=(), oracle_window=4),)
    with pytest.raises(ValueError, match="[Bb]elady|optimal"):
        PipelineSpec(backend=BackendSpec(name="host"),
                     sampler=SamplerSpec(family="khop", fanouts=(3, 2)),
                     store=StoreSpec(kind="disk", mode="isp"),
                     cache_tiers=tiers, batch_size=8)
    with pytest.raises(ValueError, match="backend"):
        PipelineSpec(backend=BackendSpec(name="isp"),
                     sampler=SamplerSpec(family="khop", fanouts=(3, 2)),
                     store=StoreSpec(kind="disk", mode="isp"),
                     batch_size=8)


def test_isp_spec_json_roundtrip():
    spec = _isp_spec(isp={"transport": "unix", "window": 6,
                          "server_cache": False})
    d = spec.to_dict()
    assert d["store"]["mode"] == "isp"
    assert d["store"]["isp"]["window"] == 6
    back = PipelineSpec.from_dict(d)
    assert back == spec
    assert back.store.isp.server_cache is False


# ---------------------------------------------------------------------------
# against the reference: clients and servers across packages, wire bytes
# ---------------------------------------------------------------------------

def _pushdown_equals_host(store, g, targets, seed):
    trace, hop_feats, labels = store.sample_khop_pushdown(targets, (3, 2),
                                                          seed=seed)
    ref = sample_khop(g, targets, (3, 2), seed=seed)
    for h, r in zip(trace.hops, ref.hops):
        np.testing.assert_array_equal(h, r)
    for h, f in zip(ref.hops, hop_feats):
        np.testing.assert_array_equal(f, g.features[h])
    np.testing.assert_array_equal(labels, g.labels[targets])


@pytest.mark.parametrize("server_pkg", ["reference", "port"])
def test_clients_and_servers_interoperate(small_graph, disk_dir, tmp_path,
                                          monkeypatch, server_pkg):
    """A port client against a spawned reference server (jax on the
    CPU), and a reference client against a spawned port server: the
    handshake, the pushdown (equal to host sampling), a gather, the
    stats, and a clean shutdown with exit 0."""
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    sock = str(tmp_path / "x.sock")
    config = {"transport": "unix", "address": sock,
              "store": {"path": disk_dir, "cache_mb": 2.0}}
    if server_pkg == "reference":
        proc = ref_server.spawn_server(config)
        make = lambda: RemoteGraphStore(                        # noqa: E731
            IspClient("unix", sock, window=4, connect_timeout=60.0),
            server_proc=proc)
    else:
        proc = spawn_server(config)
        make = lambda: ref_client.RemoteGraphStore(             # noqa: E731
            ref_client.IspClient("unix", sock, window=4,
                                 connect_timeout=60.0), server_proc=proc)
    try:
        store = make()
        try:
            g = small_graph
            assert (store.name, store.num_nodes, store.num_edges,
                    store.feat_dim) == (g.name, g.num_nodes, g.num_edges,
                                        g.feat_dim)
            targets = np.arange(0, 64, 8, dtype=np.int32)
            _pushdown_equals_host(store, g, targets, seed=3)
            ids = np.arange(5, 40, 3, dtype=np.int64)
            np.testing.assert_array_equal(store.gather_features(ids),
                                          g.features[ids])
            np.testing.assert_array_equal(store.degrees(), g.degrees())
            assert store.stats()["server"]["requests"] > 0
        finally:
            store.close()
        assert proc.wait(timeout=30.0) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10.0)


def test_smoke_pallas_isp_stream_and_wire_equal_reference(small_graph,
                                                          tmp_path):
    """``smoke_pallas_isp.json`` (the host backend over the isp store),
    with one producer that runs no batch ahead, so the wire carries
    exactly the consumed batches: batches 0-2 equal the reference's bit
    for bit, and so do both ends' wire counters and the storage
    process's I/O counters."""
    got = {}
    for tag, cfg, g in (("port", port_config, small_graph),
                        ("ref", ref_config, jload_dataset("reddit"))):
        d = cfg.PipelineSpec.load(str(SPEC_DIR / "smoke_pallas_isp.json")) \
            .to_dict()
        d["backend"].update(n_workers=1, queue_depth=1,
                            straggler_factor=1e6)
        d["store"]["path"] = str(tmp_path / tag)
        spec = cfg.PipelineSpec.from_dict(d)
        kw = {"device": "cpu"} if tag == "port" else {}
        pipe = cfg.build_pipeline(spec, g, **kw)
        try:
            batches = [pipe.get_batch(i) for i in range(3)]
            wire = pipe.store.isp_counters()
            stats = pipe.store.stats()
            proc = pipe.store.server_proc
        finally:
            pipe.close()
        got[tag] = (batches, wire, stats, proc)
    for x, y in zip(got["port"][0], got["ref"][0]):
        _assert_same_batch(x, y)
        assert x.trace.io == y.trace.io
    assert got["port"][1] == got["ref"][1]
    port_stats, ref_stats = got["port"][2], got["ref"][2]
    for k in ("bytes_tx", "bytes_rx", "requests", "commands"):
        assert port_stats["server_wire"][k] == ref_stats["server_wire"][k], k
    assert port_stats["server"] == {**ref_stats["server"],
                                    "planner": port_stats["server"]
                                    ["planner"]}
    assert got["port"][1]["bytes_rx"] > 0
    assert got["port"][3].poll() == 0 and got["ref"][3].poll() == 0


def test_pallas_device_caches_over_isp_equal_local(small_graph, tmp_path):
    """The pallas backend with both device tiers, overlapped, over the
    isp store: the device caches fetch their misses over the wire, and
    batches 0-3 (ids, features, labels) and each batch's device-tier
    counters equal the same pipeline's over the local store."""
    def run(mode, sub):
        spec = PipelineSpec(
            backend=BackendSpec(name="pallas"),
            store=StoreSpec(kind="disk", mode=mode, io_threads=4,
                            path=str(tmp_path / sub)),
            cache_tiers=(
                CacheTierSpec(tier="host", policy="lru", capacity_mb=2.0,
                              arrays=()),
                CacheTierSpec.device(rows=48, edge_blocks=16,
                                     policy="lru")),
            prefetch=PrefetchSpec(depth=2, overlap=True, stage_depth=2),
            batch_size=8)
        with build_pipeline(spec, small_graph, device="cpu") as pipe:
            batches = [pipe.get_batch(i) for i in range(4)]
            stats = pipe.stats()
        return batches, stats

    local, _ = run("local", "l")
    isp, istats = run("isp", "i")
    for x, y in zip(local, isp):
        _assert_same_batch(x, y)
        # the tiers' per-batch counters (planned in batch order; the
        # lanes run a varying number of batches ahead of the totals)
        for tier in ("devcache", "edgecache"):
            assert x.trace.io[tier] == y.trace.io[tier], tier
    wire = istats["store"]["server_wire"]["commands"]
    assert wire["gather_edge_blocks"] > 0 and wire["gather_features"] > 0
