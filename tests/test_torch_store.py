"""The port's GraphStore layer (``repro_torch.storage.store`` and its
page-cache, checksum and graph-access helpers) against the reference's.

The on-disk layout is byte-identical, either package reads the other's
store, and for the same sequence of reads the two ``DiskStore``s return
the same arrays and the same I/O counters, for the lru and pinned page
caches, a cache small enough to evict, and a pread pool.
"""

import os

import numpy as np
import pytest

from repro.core import load_dataset as jload_dataset
from repro.core import rmat_graph as jrmat_graph
from repro.storage import DiskStore as JDiskStore
from repro.storage import InMemoryStore as JInMemoryStore
from repro.storage import RetrySpec as JRetrySpec
from repro.storage import StoreReadError as JStoreReadError
from repro.storage import block_checksums as jblock_checksums
from repro.storage import crc32c as jcrc32c
from repro.storage import open_store as jopen_store
from repro.storage import save_graph as jsave_graph
from repro.storage.blockdev import LRUCache as JLRUCache
from repro_torch.core import load_dataset, rmat_graph
from repro_torch.storage import (DiskStore, InMemoryStore, LRUCache,
                                 RetrySpec, StoreReadError, block_checksums,
                                 crc32c, open_store, save_graph)
from repro_torch.storage.store import MANIFEST
from repro_torch.storage.faults import FaultSpec

BLOCK_E = 512


@pytest.fixture(scope="module")
def graphs():
    return jload_dataset("reddit"), load_dataset("reddit")


@pytest.fixture(scope="module")
def ref_dir(graphs, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref-store"))
    jsave_graph(graphs[0], path)
    return path


def _files(path):
    return {f: open(os.path.join(path, f), "rb").read()
            for f in sorted(os.listdir(path))}


@pytest.mark.parametrize("which,block_bytes", [("reddit", None),
                                               ("reddit", 1024),
                                               ("rmat-nofeat", 512)])
def test_save_graph_writes_reference_bytes(which, block_bytes, tmp_path):
    if which == "reddit":
        jg, g = jload_dataset("reddit"), load_dataset("reddit")
    else:
        jg, g = jrmat_graph(200, 1500, seed=3), rmat_graph(200, 1500, seed=3)
    jsave_graph(jg, str(tmp_path / "ref"), block_bytes=block_bytes)
    manifest = save_graph(g, str(tmp_path / "port"), block_bytes=block_bytes)
    want, got = _files(tmp_path / "ref"), _files(tmp_path / "port")
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    assert manifest["version"] == 2 and MANIFEST in got


def test_port_reads_reference_store(graphs, ref_dir):
    g = graphs[1]
    st = DiskStore(ref_dir)
    back = st.to_csr()
    for a, b in ((back.indptr, g.indptr), (back.indices, g.indices),
                 (back.features, g.features), (back.labels, g.labels)):
        np.testing.assert_array_equal(a, b)
    nofeat = st.to_csr(include_features=False)
    assert nofeat.features is None
    np.testing.assert_array_equal(nofeat.indices, g.indices)
    ref = JDiskStore(ref_dir)
    assert st.nbytes_on_disk() == ref.nbytes_on_disk()
    st.close()
    ref.close()


def _reads(seed, deg):
    """One mixed read sequence: (method, args) pairs; edge offsets are
    drawn below each row's degree, as the samplers draw them."""
    rng = np.random.default_rng(seed)
    seq = []
    for _ in range(3):
        ids = rng.integers(0, deg.size, (6, 5))
        off = rng.integers(0, 2**31 - 1, (6, 3)) % np.maximum(
            deg[ids[:, 1]], 1)[:, None]
        seq += [("gather_features", (ids,)),
                ("gather_labels", (ids[:, 0],)),
                ("gather_edge_blocks", (rng.integers(0, 45, 9), BLOCK_E)),
                ("gather_edges", (ids[:, 1], off)),
                ("neighbors", (int(ids[0, 2]),))]
    return seq


@pytest.mark.parametrize("kw", [dict(),
                                dict(policy="pinned", cache_mb=0.125),
                                dict(cache_blocks=6, lock_shards=2),
                                # with a pool, the order of concurrent
                                # reads is the threads': a cache that
                                # evicts would make the counters race
                                dict(io_threads=2, lock_shards=2),
                                dict(policy="pinned", cache_mb=4,
                                     io_threads=2, lock_shards=4)],
                         ids=["lru", "pinned", "evicting", "pool",
                              "pinned-pool"])
def test_reads_and_io_counters_equal_reference(graphs, ref_dir, kw):
    """Same reads, same arrays, same global and per-thread counters."""
    ref, port = JDiskStore(ref_dir, **kw), DiskStore(ref_dir, **kw)
    assert port.io_counters() == ref.io_counters()     # pinned preload
    assert (port.cache_blocks, port.lock_shards) == (ref.cache_blocks,
                                                     ref.lock_shards)
    for name, args in _reads(len(kw), graphs[1].degrees()):
        want = getattr(ref, name)(*args)
        got = getattr(port, name)(*args)
        np.testing.assert_array_equal(got, want, err_msg=name)
        assert got.dtype == want.dtype
        assert port.io_counters() == ref.io_counters(), name
        assert port.thread_io_counters() == ref.thread_io_counters(), name
    assert port.stats() == ref.stats()
    ref.close()
    port.close()


def test_io_attribution_bills_the_installed_context(ref_dir):
    ref, port = (JDiskStore(ref_dir, cache_blocks=16, io_threads=2,
                            lock_shards=2),
                 DiskStore(ref_dir, cache_blocks=16, io_threads=2,
                           lock_shards=2))
    ids = np.arange(0, 1024, 37)
    ctxs = []
    for st in (ref, port):
        ctx = st.make_io_context()
        with st.io_attribution(ctx):
            st.gather_features(ids)
        ctxs.append(ctx.counters())
        assert st.thread_io_counters() == dict.fromkeys(ctxs[-1], 0)
    assert ctxs[0] == ctxs[1] and ctxs[1]["requests"] == ids.size
    ref.close()
    port.close()


def test_crc32c_equals_reference():
    rng = np.random.default_rng(0)
    for n in (0, 1, 9, 4096):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert crc32c(data) == jcrc32c(data)
        assert crc32c(data[n // 2:], crc32c(data[:n // 2])) == crc32c(data)
    assert crc32c(b"123456789") == 0xE3069283        # the CRC-32C check value
    buf = rng.integers(0, 256, 8 * 512, dtype=np.uint8).tobytes()
    np.testing.assert_array_equal(block_checksums(buf, 512),
                                  jblock_checksums(buf, 512))


def _corrupt(path, tmp_path):
    """A copy of the store at ``path`` with one byte of the first feature
    block flipped."""
    import shutil
    dst = str(tmp_path / "corrupt")
    shutil.copytree(path, dst)
    with open(os.path.join(dst, "features.bin"), "r+b") as f:
        f.seek(100)
        b = f.read(1)
        f.seek(100)
        f.write(bytes([b[0] ^ 0x10]))
    return dst


def test_verify_turns_a_corrupt_block_into_store_read_error(ref_dir,
                                                            tmp_path):
    path = _corrupt(ref_dir, tmp_path)
    counters = []
    for cls, retry, err in ((JDiskStore, JRetrySpec, JStoreReadError),
                            (DiskStore, RetrySpec, StoreReadError)):
        st = cls(path, verify=True, retry=retry(max_attempts=3,
                                                backoff_s=0.0))
        clean = cls(ref_dir)
        np.testing.assert_array_equal(st.gather_labels(np.arange(5)),
                                      clean.gather_labels(np.arange(5)))
        clean.close()
        with pytest.raises(err, match="CRC32C"):
            st.gather_features(np.array([0]))
        counters.append(st.io_counters())
        st.close()
    assert counters[0] == counters[1]
    assert counters[1]["corrupt_blocks"] == 3 and counters[1]["retries"] == 2
    # without verify the flipped byte is read as it is
    st = DiskStore(path)
    assert st.gather_features(np.array([0])).shape == (1, 602)
    st.close()


def test_deferred_options_are_refused(ref_dir):
    st = DiskStore(ref_dir, policy="optimal", lock_shards=4)
    assert (st.policy, st.lock_shards) == ("optimal", 1)   # unsharded
    st.close()
    for kw, what in ((dict(policy="mru"), "unknown cache policy"),
                     (dict(faults=FaultSpec(bitflip_rate=0.1)), "verify"),
                     (dict(io_threads=0), "io_threads must be >= 1")):
        with pytest.raises(ValueError, match=what):
            DiskStore(ref_dir, **kw)


def test_open_store_and_in_memory_store(graphs, tmp_path):
    jg, g = graphs
    mem, jmem = open_store("mem", g=g), jopen_store("mem", g=jg)
    assert isinstance(mem, InMemoryStore) and isinstance(jmem,
                                                         JInMemoryStore)
    assert mem.io_counters() == jmem.io_counters()
    assert mem.stats() == jmem.stats()
    ids = np.array([3, 1, 3, 700])
    np.testing.assert_array_equal(mem.gather_features(ids),
                                  jmem.gather_features(ids))
    np.testing.assert_array_equal(mem.gather_edge_blocks(np.arange(4), 256),
                                  jmem.gather_edge_blocks(np.arange(4), 256))
    path = str(tmp_path / "s")
    st = open_store("disk", g=g, path=path, cache_mb=1)
    assert st.name == g.name and st.num_edges == g.num_edges
    st.close()
    other = load_dataset("amazon")
    with pytest.raises(ValueError, match="holds graph"):
        open_store("disk", g=other, path=path)
    with pytest.raises(KeyError):
        open_store("tape", g=g)


def test_graph_access_methods_equal_reference(graphs):
    jg, g = graphs
    rng = np.random.default_rng(4)
    rows = rng.integers(0, g.num_nodes, 20)
    off = rng.integers(0, 3, (20, 4))
    np.testing.assert_array_equal(g.gather_edges(rows, off),
                                  jg.gather_edges(rows, off))
    np.testing.assert_array_equal(g.out_degrees(rows), jg.out_degrees(rows))
    blocks = np.array([0, 5, 40, 41, 100])        # past the end: zeros
    np.testing.assert_array_equal(g.gather_edge_blocks(blocks, 512),
                                  jg.gather_edge_blocks(blocks, 512))
    for u in (0, int(np.argmax(g.degrees()))):
        assert g.edge_byte_range(u, 4) == jg.edge_byte_range(u, 4)
        np.testing.assert_array_equal(g.neighbors(u), jg.neighbors(u))
    np.testing.assert_array_equal(g.gather_labels(rows),
                                  jg.gather_labels(rows))


def test_lru_cache_equals_reference():
    rng = np.random.default_rng(1)
    a, b = LRUCache(5), JLRUCache(5)
    for blk in rng.integers(0, 12, 200):
        blk = int(blk)
        ga, gb = a.get(blk), b.get(blk)
        assert ga == gb
        if ga is None:
            assert a.put(blk, blk * 2) == b.put(blk, blk * 2)
    assert (a.hits, a.misses, a.evictions) == (b.hits, b.misses, b.evictions)


def test_concurrent_readers_conserve_counters(graphs, ref_dir):
    """Eight reader threads, each billing its own IOContext, over a pread
    pool and an evicting two-shard page cache, with a short switch
    interval: every read returns the right rows, and the per-context
    bills add up to the store's totals (a lost update would break it)."""
    import sys
    import threading
    g = graphs[1]
    st = DiskStore(ref_dir, cache_blocks=32, lock_shards=2, io_threads=4)
    ctxs, errors = [], []

    def reader(seed):
        rng = np.random.default_rng(seed)
        ctx = st.make_io_context()
        ctxs.append(ctx)
        try:
            with st.io_attribution(ctx):
                for _ in range(6):
                    ids = rng.integers(0, g.num_nodes, 24)
                    np.testing.assert_array_equal(st.gather_features(ids),
                                                  g.features[ids])
                    np.testing.assert_array_equal(
                        st.gather_edge_blocks(ids[:8] % 40, BLOCK_E),
                        g.gather_edge_blocks(ids[:8] % 40, BLOCK_E))
        except Exception as e:      # reported to the main thread below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=reader, args=(s,))
                   for s in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    total = st.io_counters()
    billed = {k: sum(c.counters()[k] for c in ctxs) for k in total}
    for k in ("requests", "block_fetches", "bytes_fetched", "misses"):
        assert billed[k] == total[k], k
    assert billed["hits"] == total["hits"]
    assert total["evictions"] > 0 and total["misses"] > 0
    st.close()
