"""The port's plots against the JAX package's, artist for artist, on the Agg
backend: the two-community fixture of tests/test_plotting.py:17-48 through
both packages (the port session loads the JAX session's networkx graph, so
the layouts are the same), then the figures' data compared: scatter offsets
equal, face colours within 1e-12, the contour circle within 1e-9, edge
segments (sampled ones too) equal. Also the colormaps, the xlsx reader and
the Costanzo overlay."""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import networkx as nx  # noqa: E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from safepy_tpu import SAFE as JaxSAFE  # noqa: E402
from safepy_tpu import plotting as jax_plotting  # noqa: E402
from safepy_tpu.colormaps import MidpointRangeNormalize as JaxNormalize  # noqa: E402
from safepy_tpu.colormaps import get_colors as jax_get_colors  # noqa: E402
from safepy_tpu.io.xlsx import read_xlsx as jax_read_xlsx  # noqa: E402
from safepy_tpu_torch import SAFE  # noqa: E402
from safepy_tpu_torch import plotting  # noqa: E402
from safepy_tpu_torch.colormaps import get_colors  # noqa: E402
from safepy_tpu_torch.io.xlsx import read_xlsx  # noqa: E402
from test_plotting import _write_min_xlsx  # noqa: E402

torch.set_num_threads(1)

COSTANZO = ("Data File S5_SAFE analysis_Gene cluster identity and functional "
            "enrichments")
REGION, GENE = "Global Similarity Network Region name", "Gene/Allele"


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(JAX session, port session) of tests/test_plotting.py's fixture."""
    rng = np.random.default_rng(0)
    n, half = 80, 40
    g = nx.Graph()
    g.add_edges_from(nx.connected_watts_strogatz_graph(half, 6, 0.1,
                                                       seed=1).edges())
    g2 = nx.connected_watts_strogatz_graph(n - half, 6, 0.1, seed=2)
    g.add_edges_from(((u + half, v + half) for u, v in g2.edges()))
    g.add_edge(0, half)
    path = tmp_path_factory.mktemp("plotdata") / "net.txt"
    with open(path, "w") as f:
        for u, v in g.edges():
            f.write(f"g{u}\tg{v}\t1.0\n")
    vals = np.zeros((n, 6))
    vals[:half, :3] = (rng.random((half, 3)) < 0.8)
    vals[half:, 3:] = (rng.random((n - half, 3)) < 0.8)

    jax_sf = JaxSAFE(verbose=False)
    jax_sf.random_seed = 3
    jax_sf.load_network(network_file=str(path), node_key_attribute="key")
    labels = [jax_sf.graph.nodes[i]["key"] for i in range(n)]
    df = pd.DataFrame(vals, index=labels,
                      columns=[f"attr {i}" for i in range(6)])
    sf = SAFE(verbose=False, device="cpu")
    sf.random_seed = 3
    sf.load_network(network_file=jax_sf.graph, node_key_attribute="key")
    for s in (jax_sf, sf):
        s.define_neighborhoods()
        s.load_attributes(attribute_file=df)
        s.compute_pvalues()
        s.define_top_attributes(attribute_enrichment_min_size=3)
        s.define_domains()
        s.trim_domains()
    np.testing.assert_array_equal(sf.nes, jax_sf.nes)
    return jax_sf, sf


def _collections(ax):
    return [(type(c).__name__, c) for c in ax.collections]


def assert_same_axes(want, got):
    """Scatter offsets equal, face colours within 1e-12, line segments and
    contour paths equal, circle patches within 1e-9, the same limits."""
    cw, cg = _collections(want), _collections(got)
    assert [k for k, _ in cw] == [k for k, _ in cg]
    for (kind, a), (_, b) in zip(cw, cg):
        if kind == "PathCollection":
            np.testing.assert_array_equal(np.asarray(b.get_offsets()),
                                          np.asarray(a.get_offsets()))
            np.testing.assert_allclose(b.get_facecolors(), a.get_facecolors(),
                                       rtol=0, atol=1e-12)
        elif kind == "LineCollection":
            sa, sb = a.get_segments(), b.get_segments()
            assert len(sa) == len(sb)
            for p, q in zip(sa, sb):
                np.testing.assert_array_equal(q, p)
        else:  # contour sets
            for p, q in zip(a.get_paths(), b.get_paths()):
                np.testing.assert_array_equal(q.vertices, p.vertices)
    assert len(want.patches) == len(got.patches)
    for p, q in zip(want.patches, got.patches):
        np.testing.assert_allclose(q.center, p.center, rtol=0, atol=1e-9)
        assert abs(q.radius - p.radius) <= 1e-9
    assert got.get_xlim() == want.get_xlim()
    assert got.get_ylim() == want.get_ylim()
    assert [t.get_text() for t in got.texts] == \
        [t.get_text() for t in want.texts]
    assert got.get_title() == want.get_title()


def test_fixture_sessions_agree(pair):
    jax_sf, sf = pair
    assert sf.domains is not None
    np.testing.assert_array_equal(sf.domains["id"], jax_sf.domains["id"])
    assert list(sf.domains["label"]) == list(jax_sf.domains["label"])
    np.testing.assert_array_equal(sf.node2domain["primary_domain"],
                                  jax_sf.node2domain["primary_domain"])


@pytest.mark.parametrize("each", [False, True], ids=["composite", "each"])
def test_composite_network_matches_jax(pair, each):
    jax_sf, sf = pair
    fw, aw = jax_sf.plot_composite_network(show_each_domain=each,
                                           color_seed=0)
    fg, ag = sf.plot_composite_network(show_each_domain=each, color_seed=0)
    assert len(aw) == len(ag)
    for a, b in zip(aw, ag):
        assert_same_axes(a, b)
    assert fg.get_facecolor() == fw.get_facecolor()
    assert [list(map(float, c)) for c in sf.domains["rgba"]] == \
        [list(map(float, c)) for c in jax_sf.domains["rgba"]]
    plt.close("all")


def test_composite_contours_match_jax(pair):
    jax_sf, sf = pair
    _, aw = jax_sf.plot_composite_network_contours(color_seed=0)
    _, ag = sf.plot_composite_network_contours(color_seed=0)
    for a, b in zip(aw, ag):
        assert_same_axes(a, b)
    assert len(ag[1].collections) >= 2
    plt.close("all")


@pytest.mark.parametrize("kwargs", [
    dict(attributes=["attr 0", "attr 4"], show_raw_data=True,
         show_significant_nodes=True),
    dict(attributes=3, top_attributes_only=True, seed=1,
         show_colorbar=False, background_color="#ffffff"),
], ids=["named", "sampled-top"])
def test_sample_attributes_match_jax(pair, kwargs):
    jax_sf, sf = pair
    fw, aw = jax_sf.plot_sample_attributes(**kwargs)
    fg, ag = sf.plot_sample_attributes(**kwargs)
    assert len(fw.axes) == len(fg.axes)  # the colorbars included
    for a, b in zip(aw, ag):
        assert_same_axes(a, b)
    plt.close("all")


def test_plot_network_with_labels_matches_jax(pair):
    jax_sf, sf = pair
    want = jax_sf.plot_network(labels=["g0", "g1", "not-there"])
    got = sf.plot_network(labels=["g0", "g1", "not-there"])
    assert_same_axes(want, got)
    assert got.get_figure().get_facecolor() == \
        want.get_figure().get_facecolor()
    plt.close("all")


@pytest.mark.parametrize("minimum,seed", [(100, 5), (241, 7), (242, 0)])
def test_edge_sample_matches_jax(pair, minimum, seed):
    """At random_sampling_edges_min at or below the 241 edges, a tenth of
    them, the positions random.Random(seed) takes; above it, every edge."""
    jax_sf, sf = pair
    assert sf.graph.number_of_edges() == 241
    fig, (a, b) = plt.subplots(1, 2)
    jax_plotting.plot_network(jax_sf.graph, ax=a,
                              random_sampling_edges_min=minimum, seed=seed)
    plotting.plot_network(sf.graph, ax=b, random_sampling_edges_min=minimum,
                          seed=seed)
    assert_same_axes(a, b)
    expect = 24 if minimum <= 241 else 241
    assert len(b.collections[1].get_segments()) == expect
    plt.close("all")


def test_mixture_colors_match_and_reuse(pair):
    """The counts of node2domain and the host sums of the indicator give the
    same colors, as in JAX; a bumped enrichment serial takes the sums."""
    jax_sf, sf = pair
    _, rgb = plotting._domain_colors(sf, seed=0)
    _, jax_rgb = jax_plotting._domain_colors(jax_sf, seed=0)
    np.testing.assert_array_equal(rgb, jax_rgb)
    reused = plotting._domain_mixture_colors(sf, rgb)
    np.testing.assert_allclose(
        reused, jax_plotting._domain_mixture_colors(jax_sf, jax_rgb),
        rtol=0, atol=1e-12)
    saved = sf.node2domain.counts.copy()
    try:
        sf.node2domain.counts[:] = 999.0  # a stale node2domain
        sf._enrichment_serial += 1
        np.testing.assert_array_equal(
            plotting._domain_mixture_colors(sf, rgb), reused)
    finally:
        sf.node2domain.counts[:] = saved
        sf._enrichment_serial -= 1


def test_select_attributes_matches_jax(pair):
    jax_sf, sf = pair
    for args in [(2, False, 0), (99, True, 0), ("attr 3", False, None),
                 (["attr 5", "attr 0"], False, None)]:
        np.testing.assert_array_equal(
            plotting._select_attributes(sf, *args),
            jax_plotting._select_attributes(jax_sf, *args))


@pytest.mark.parametrize("seed,n", [(4, 7), (0, 3), (None, 1)])
def test_get_colors_match_jax(seed, n):
    if seed is None:
        np.testing.assert_array_equal(get_colors("hsv", n), [[0, 0, 0, 1]])
        return
    np.testing.assert_array_equal(get_colors("hsv", n, seed=seed),
                                  jax_get_colors("hsv", n, seed=seed))


def test_midpoint_normalize_matches_jax():
    from safepy_tpu_torch.colormaps import MidpointRangeNormalize

    x = np.array([-12, -10, -3.0, -1.3, -0.2, 0, 0.7, 1.3, 5, 10, np.nan])
    ours = MidpointRangeNormalize(vmin=-10, vmax=10, midrange=[-1.3, 0, 1.3])
    theirs = JaxNormalize(vmin=-10, vmax=10, midrange=[-1.3, 0, 1.3])
    got, want = ours(x), theirs(x)
    np.testing.assert_array_equal(np.ma.getmaskarray(got),
                                  np.ma.getmaskarray(want))
    np.testing.assert_array_equal(got.filled(-1), want.filled(-1))
    np.testing.assert_allclose(np.asarray(ours(np.array([-10, -1.3, 0, 1.3,
                                                         10]))),
                               [0, 0.25, 0.5, 0.75, 1])


def _xlsx_equal(ours: dict, theirs: pd.DataFrame):
    assert list(ours) == list(theirs.columns)
    for name, col in ours.items():
        want = theirs[name].tolist()
        got = list(col)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert (pd.isna(a) and pd.isna(b)) or a == b, (name, a, b)


def test_xlsx_reader_matches_jax(tmp_path):
    path = tmp_path / "t.xlsx"
    _write_min_xlsx(path, "Sheet One", ["name", "score", "note", "n"],
                    [["alpha", 1.5, "x", 1], ["beta", 3, None, 2],
                     ["gamma & <co>", -2.25, "y", 3]])
    ours = read_xlsx(str(path), sheet_name="Sheet One")
    _xlsx_equal(ours, jax_read_xlsx(str(path), sheet_name="Sheet One"))
    assert ours["n"].dtype == np.int64 and ours["score"].dtype == np.float64
    assert ours["note"][0] == "x" and np.isnan(ours["note"][1])
    with pytest.raises(ValueError, match="not in workbook"):
        read_xlsx(str(path), sheet_name="nope")


def test_xlsx_gap_rows_and_absolute_target(tmp_path):
    """A left-out row reads as an all-NaN row; a rooted relationship target
    resolves (tests/test_plotting.py:328-356)."""
    import re
    import zipfile

    path = tmp_path / "gap.xlsx"
    _write_min_xlsx(path, "S", ["a", "b"], [["r2", 1], ["r3", 2], ["r4", 3]])
    with zipfile.ZipFile(path) as zf:
        parts = {n: zf.read(n).decode() for n in zf.namelist()}
    parts["xl/worksheets/sheet1.xml"] = re.sub(
        r'<row r="3">.*?</row>', "", parts["xl/worksheets/sheet1.xml"])
    parts["xl/_rels/workbook.xml.rels"] = parts[
        "xl/_rels/workbook.xml.rels"].replace(
        'Target="worksheets/sheet1.xml"', 'Target="/xl/worksheets/sheet1.xml"')
    with zipfile.ZipFile(path, "w") as zf:
        for name, data in parts.items():
            zf.writestr(name, data)
    ours = read_xlsx(str(path), sheet_name="S")
    _xlsx_equal(ours, jax_read_xlsx(str(path), sheet_name="S"))
    assert len(ours["a"]) == 3 and np.isnan(ours["b"][1])


@pytest.mark.parametrize("fmt", ["tsv", "xlsx"])
def test_costanzo_overlay_matches_jax(pair, tmp_path, fmt):
    """The published-region contours over a synthetic bundle, from a .tsv
    and from an .xlsx, equal JAX's; one contour set a region."""
    jax_sf, sf = pair
    other = tmp_path / "other"
    other.mkdir()
    rows = [("Process One", f"g{i}") for i in range(0, 40, 2)]
    rows += [("Process Two", f"g{i}") for i in range(40, 80, 2)]
    rows += [(None, "g1")]
    base = str(other / COSTANZO)
    if fmt == "tsv":
        pd.DataFrame(rows, columns=[REGION, GENE]).to_csv(
            base + ".tsv", sep="\t", index=False)
    else:
        _write_min_xlsx(base + ".xlsx", "Global net. cluster gene list",
                        [REGION, GENE], [list(r) for r in rows])
    pd.DataFrame({"R": [255, 0, 64], "G": [0, 255, 64],
                  "B": [0, 0, 192]}).to_csv(other / "costanzo_2016_colors.txt",
                                            sep="\t", index=False)
    fig, (a, b) = plt.subplots(1, 2)
    jax_plotting.plot_costanzo2016_network_annotations(jax_sf.graph, a,
                                                       str(tmp_path))
    plotting.plot_costanzo2016_network_annotations(sf.graph, b, str(tmp_path))
    assert len(b.collections) == 2
    assert_same_axes(a, b)
    np.testing.assert_array_equal(b.collections[0].get_edgecolor(),
                                  a.collections[0].get_edgecolor())
    plt.close("all")
