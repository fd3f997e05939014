"""The port's pandas-free ``read_attributes`` against the JAX package's
pandas one: the same names, values (bitwise, NaN where NaN) and dtype, on
text files with float32 and float64 columns, integers, text cells, NA
strings, duplicate labels and headers, a ``.mat`` GO matrix, a DataFrame,
``mask_duplicates`` with the same generator, and the census log lines."""

import logging

import numpy as np
import pandas as pd
import pytest
import scipy.io as spio

from safepy_tpu.io import attributes as jax_attr
from safepy_tpu_torch.io import attributes as port_attr
from safepy_tpu_torch.io import table


def _both(source, order, **kw):
    j = jax_attr.read_attributes(attribute_file=source,
                                 node_label_order=order, verbose=False, **kw)
    p = port_attr.read_attributes(attribute_file=source,
                                  node_label_order=order, verbose=False, **kw)
    return j, p


def _assert_same(j, p):
    (ja, jorder, jv), (pa, porder, pv) = j, p
    assert list(pa["name"]) == list(ja["name"])
    assert [str(x) for x in pa["id"]] == [str(x) for x in ja["id"]]
    assert list(porder) == list(jorder)
    assert pv.dtype == jv.dtype
    np.testing.assert_array_equal(pv, jv)  # bitwise, NaN where NaN


def _write(path, header, rows):
    with open(path, "w") as f:
        f.write("\t".join(header) + "\n")
        for r in rows:
            f.write("\t".join(r) + "\n")


def test_float32_and_float64_columns(tmp_path):
    """A column whose float32 copy strays more than 5e-4 stays float64, so
    the matrix is float64; without it the matrix is float32."""
    rng = np.random.default_rng(0)
    labels = [f"g{i}" for i in range(50)]
    rows = [[lab, f"{rng.normal():.6f}", f"{rng.normal() * 1e3:.4f}",
             str(int(rng.integers(0, 5)))] for lab in labels]
    rows[3][1] = "1234567.891"
    path = str(tmp_path / "a.txt")
    _write(path, ["gene", "q", "big", "count"], rows)
    order = labels[::-1] + ["missing"]
    j, p = _both(path, order)
    _assert_same(j, p)
    assert p[2].dtype == np.float64
    for r in rows:
        r[1] = "0.5"
    _write(path, ["gene", "q", "big", "count"], rows)
    j, p = _both(path, order)
    _assert_same(j, p)
    assert p[2].dtype == np.float32


def test_na_strings_text_cells_and_duplicate_headers(tmp_path):
    rng = np.random.default_rng(1)
    na = sorted(table.NA_STRINGS)
    rows = []
    for i in range(60):
        cells = [f"{rng.normal():.5f}" for _ in range(4)]
        cells[i % 4] = na[i % len(na)]
        if i % 7 == 0:
            cells[2] = "not-a-number"
        rows.append([f"g{i % 45}"] + cells)
    rows.append(["NA", "1", "2", "3", "4"])     # an NA label
    rows.append(["NA", "5", "6", "7", "8"])     # ... twice: dropped
    path = str(tmp_path / "a.tsv")
    _write(path, ["gene", "a", "a", "", "a.1"], rows)
    order = [f"g{i}" for i in range(50)]
    j, p = _both(path, order)
    _assert_same(j, p)
    assert list(p[0]["name"]) == ["a", "a.2", "Unnamed: 3", "a.1"]


@pytest.mark.parametrize("depth", [2, 5])
def test_duplicate_labels_average_as_pandas_does(tmp_path, depth):
    """pandas' group mean sums with Kahan compensation, labels sorted."""
    rng = np.random.default_rng(depth)
    labs = [f"g{int(i)}" for i in rng.integers(0, 80 // depth, 80)]
    rows = [[lab, repr(float(rng.normal())), f"{rng.normal():.3f}"]
            for lab in labs]
    path = str(tmp_path / "d.txt")
    _write(path, ["gene", "x", "y"], rows)
    for order in (None, sorted(set(labs))[::-1]):
        j, p = _both(path, order)
        _assert_same(j, p)


def test_gz_and_number_forms(tmp_path):
    """Numbers pandas' C parser rounds differently from Python's float (17
    significant digits accumulated, then one power of ten)."""
    import gzip

    rng = np.random.default_rng(3)
    vals = rng.normal(size=300) * 10.0 ** rng.integers(-30, 30, 300)
    forms = ([repr(float(v)) for v in vals[:100]]
             + ["%.20g" % v for v in vals[100:200]]
             + ["%.25e" % v for v in vals[200:]])
    forms[:12] = ["inf", "-Infinity", " 1.5", "2. ", "+3", ".5", "1e5",
                  "12345678901234567890", "9223372036854775808", "1e-320",
                  "-1e-400", "0000000000000000001234"]
    path = str(tmp_path / "n.txt.gz")
    with gzip.open(path, "wt") as f:
        f.write("gene\tv\n")
        for i, s in enumerate(forms):
            f.write(f"g{i}\t{s}\n")
    order = [f"g{i}" for i in range(len(forms))]
    j, p = _both(path, order)
    _assert_same(j, p)
    col = pd.read_csv(path, sep="\t", dtype={0: str})["v"].to_numpy()
    ours = np.array([table.parse_float(s) for s in forms])
    np.testing.assert_array_equal(ours, col)
    assert (ours != np.array([float(s) for s in forms])).any()


def test_mat_go_matrix(tmp_path):
    go = {"term2orf": np.array([[1, 0, 1, 1], [0, 1, 0, 0], [2, 0, 0, 1]]),
          "orfs": np.array(["o1", "o2", "o3", "o2"], dtype=object),
          "term_ids": np.array(["GO:1", "GO:2", "GO:3"], dtype=object),
          "term_names": np.array(["term one", "term two", "term three"],
                                 dtype=object)}
    path = str(tmp_path / "go.mat")
    spio.savemat(path, {"go": go})
    j, p = _both(path, ["o1", "o3", "o9", "o2"])
    _assert_same(j, p)


def test_dataframe_and_mask_duplicates():
    rng = np.random.default_rng(5)
    df = pd.DataFrame({"a": rng.normal(size=30).astype(np.float32),
                       "b": rng.integers(0, 3, 30)},
                      index=[f"n{i % 12}" for i in range(30)])
    order = [f"n{i % 10}" for i in range(25)]
    j, p = _both(df, order)
    _assert_same(j, p)
    j, p = (jax_attr.read_attributes(
        attribute_file=df, node_label_order=order, verbose=False,
        mask_duplicates=True, rng=np.random.default_rng(9)),
        port_attr.read_attributes(
            attribute_file=df, node_label_order=order, verbose=False,
            mask_duplicates=True, rng=np.random.default_rng(9)))
    _assert_same(j, p)
    assert np.isnan(p[2]).all(axis=1).sum() == 15


def test_census_log_lines(tmp_path, caplog):
    rows = [["g0", "1", "0"], ["g1", "-2", ""], ["g1", "4", "1"],
            ["gX", "9", "9"], ["gY", "0", "2"]]
    path = str(tmp_path / "c.txt")
    _write(path, ["gene", "a", "b"], rows)
    logs = []
    for read in (jax_attr.read_attributes, port_attr.read_attributes):
        caplog.clear()
        with caplog.at_level(logging.INFO):
            read(attribute_file=path, node_label_order=["g0", "g1", "g2"],
                 verbose=True)
        logs.append([r.getMessage() for r in caplog.records])
    assert logs[0] == logs[1]
    assert any("2 other" in m or "gX" in m for m in logs[1])
