"""The NumPy columnar helpers that replaced pandas on the CLI main path,
checked against pandas (kept as the oracle in tests only)."""
import numpy as np
import pytest

from svscope_tpu.utils import table as tb

pd = pytest.importorskip("pandas")


@pytest.mark.parametrize("kind", ["int", "str"])
def test_group_rows_matches_pandas_groupby(kind):
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 12, 200)
    if kind == "str":
        keys = np.array([f"read{k}" for k in keys], dtype=object)
    got = tb.group_rows(keys)
    exp = list(pd.Series(np.arange(len(keys))).groupby(keys, sort=True))
    assert [k for k, _ in got] == [k for k, _ in exp]
    for (_, rows), (_, g) in zip(got, exp):
        assert rows.tolist() == g.tolist()


@pytest.mark.parametrize("empty", [False, True])
def test_write_tsv_matches_to_csv(tmp_path, empty):
    """Headed, indexed output (RandomForestResult.tsv) with NaN, float32,
    float64, bool and int columns — byte for byte what to_csv wrote."""
    n = 0 if empty else 3
    t = {"window": np.array([f"c_{i}-{i + 5}" for i in range(n)], object),
         "z": np.array([0.1, np.nan, -1.25e-7][:n]),
         "p": np.array([0.604119, 0.5, 1.0][:n], np.float32),
         "y": np.array([True, False, True][:n]),
         "k": np.array([3, -4, 0][:n], np.int64)}
    cols = list(t)
    ours = tmp_path / "ours.tsv"
    tb.write_tsv(str(ours), t, cols, index="window")
    df = pd.DataFrame(t, columns=cols)
    if not empty:
        df.index = df.window
    theirs = tmp_path / "pandas.tsv"
    df.to_csv(theirs, sep="\t")
    assert ours.read_text() == theirs.read_text()


def test_read_rows_matches_read_csv_dedupe(tmp_path):
    p = tmp_path / "raw.bed"
    p.write_text("chr1\t5\t9\tA;C\tr1\t2\n"
                 "chr1\t5\t9\tA;C\tr1\t2\n"
                 "chr2\t1\t4\t-\t-\t0\n")
    got = tb.read_rows(str(p))
    exp = pd.read_csv(p, sep="\t", header=None).drop_duplicates()
    assert got == exp.astype(str).values.tolist()


def test_concat_and_take():
    a = {"x": np.array([1, 2]), "y": np.array(["a", "b"], object)}
    b = {"x": np.array([3]), "y": np.array(["c"], object)}
    c = tb.concat([a, {}, b], ["x", "y"])
    assert c["x"].tolist() == [1, 2, 3] and c["y"].tolist() == ["a", "b", "c"]
    assert tb.take(c, c["x"] > 1)["y"].tolist() == ["b", "c"]
    assert tb.n_rows(tb.concat([], ["x"])) == 0
