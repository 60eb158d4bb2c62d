"""The generators are pure functions of their seed."""
import numpy as np

from portbench import generators as g


def test_training_data_is_deterministic_in_the_seed():
    big = 2 ** 31 + 12345                 # seeds pass 32 bits
    X1, y1 = g.training_data(big, 1000)
    X2, y2 = g.training_data(big, 1000)
    assert np.array_equal(X1, X2) and np.array_equal(y1, y2)
    X3, _ = g.training_data(big + 1, 1000)
    assert not np.array_equal(X1, X3)
    assert X1.shape == (1000, 28) and X1.dtype == np.float32
    assert set(np.unique(y1)) <= {0.0, 1.0}
    assert 0.4 < y1.mean() < 0.6          # balanced: unit weights


def test_ctr_chunk_is_deterministic_in_the_seed():
    a = g.ctr_chunk(7, 500, 1 << 16)
    b = g.ctr_chunk(7, 500, 1 << 16)
    for k in a:
        assert np.array_equal(a[k], b[k])
    assert a["idx"].shape == (500, 26) and a["num"].shape == (500, 13)
    assert a["idx"].max() < 1 << 16


def test_ctr_zipf_is_deterministic_and_skewed():
    card = [1460, 583, 10131227, 3] + [24] * 22
    a = g.ctr_zipf(2 ** 31 + 9, 4000, 1 << 20, card)
    b = g.ctr_zipf(2 ** 31 + 9, 4000, 1 << 20, card)
    for k in a:
        assert np.array_equal(a[k], b[k])
    c = g.ctr_zipf(2 ** 31 + 10, 4000, 1 << 20, card)
    assert not np.array_equal(a["idx"], c["idx"])
    idx = a["idx"]
    assert idx.shape == (4000, 26) and idx.min() >= 0 and idx.max() < 1 << 20
    # a column of 3 values keeps 3 keys; a column of 10M repeats its head
    assert len(np.unique(idx[:, 3])) == 3
    assert len(np.unique(idx[:, 2])) < 0.9 * len(idx)
    assert 0.15 < a["y"].mean() < 0.4
