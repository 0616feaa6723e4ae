"""repro_torch.data against repro.data: the same numpy pipeline, so the
problem arrays must come out bit-identical."""

import numpy as np
import pytest

import repro.data as jd
from repro.api import DataSpec as JDataSpec
import repro_torch.data as td
from repro_torch.api import DataSpec as TDataSpec


def test_dataset_shapes_match():
    assert td.DATASET_SHAPES == jd.DATASET_SHAPES


@pytest.mark.parametrize("dataset", ["tiny", "w8a"])
@pytest.mark.parametrize("seed", [0, 3])
def test_z_bit_identical(dataset, seed):
    z_t = TDataSpec(dataset=dataset, seed=seed).build()
    z_j = np.asarray(JDataSpec(dataset=dataset, seed=seed).build())
    assert z_t.dtype == np.float64 and z_t.shape == z_j.shape
    np.testing.assert_array_equal(z_t.view(np.int64), z_j.view(np.int64))


def test_explicit_shape_bit_identical():
    z_t = TDataSpec(shape=(10, 3, 12), seed=5).build()
    z_j = np.asarray(JDataSpec(shape=(10, 3, 12), seed=5).build())
    np.testing.assert_array_equal(z_t.view(np.int64), z_j.view(np.int64))


def test_libsvm_roundtrip_matches(tmp_path):
    x, y = td.make_synthetic_logreg((6, 2, 5), seed=1)
    path = tmp_path / "toy.svm"
    td.write_libsvm(path, x, y)
    xt, yt = td.parse_libsvm(path, n_features=x.shape[1])
    xj, yj = jd.parse_libsvm(path, n_features=x.shape[1])
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_array_equal(yt, yj)
    z_t = TDataSpec(libsvm=str(path), clients=2, per_client=5).build()
    z_j = np.asarray(JDataSpec(libsvm=str(path), clients=2, per_client=5).build())
    np.testing.assert_array_equal(z_t, z_j)


def test_partition_rejects_too_few_samples():
    x = np.zeros((5, 2))
    with pytest.raises(ValueError):
        td.partition_clients(x, np.ones(5), 2, 3)
