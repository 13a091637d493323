"""The port's dataset generators against the reference's: byte-identical
arrays for every dataset."""

import numpy as np
import pytest

import repro.core.graph as jgraph
from repro_torch.core import graph


@pytest.mark.parametrize("name,large", [(n, False) for n in jgraph.DATASETS]
                         + [("reddit", True)])
def test_load_dataset_byte_identical(name, large):
    want = jgraph.load_dataset(name, large_scale=large)
    got = graph.load_dataset(name, large_scale=large)
    assert got.name == want.name
    for field in ("indptr", "indices", "features", "labels"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert a.tobytes() == b.tobytes(), field


def test_datasets_table_is_the_reference_table():
    assert graph.DATASETS == jgraph.DATASETS


@pytest.mark.parametrize("chunk_pairs", [1, 3, 100])
def test_kronecker_expand_independent_of_chunking(chunk_pairs):
    base = graph.rmat_graph(64, 256, seed=1)
    want = jgraph.kronecker_expand(jgraph.rmat_graph(64, 256, seed=1), 4,
                                   seed=2, edge_keep=0.5)
    got = graph.kronecker_expand(base, 4, seed=2, edge_keep=0.5,
                                 chunk_pairs=chunk_pairs)
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
