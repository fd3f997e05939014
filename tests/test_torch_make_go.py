"""The GO matrix tool of the port against the JAX package's: the four
cases of tests/test_make_go.py on the port, then the TSV byte for byte
against JAX's ``make_go_matrix`` on the same files, a seeded ontology
included, and the branch-root edge cases (an empty root column appended,
or refused as pandas refuses it)."""

import pickle

import numpy as np
import pytest

from safepy_tpu.utils import make_go as jax_make_go
from safepy_tpu_torch.utils import make_go
from safepy_tpu_torch.utils.make_go import (ancestors_closure, get_go_graph,
                                            make_go_matrix, parse_go_obo)
from test_make_go import GAF, OBO


def _write(tmp_path, obo=OBO, gaf=GAF):
    (tmp_path / "go.obo").write_text(obo)
    (tmp_path / "anno.gaf").write_text(gaf)
    return str(tmp_path / "go.obo"), str(tmp_path / "anno.gaf")


def test_parse_obo(tmp_path):
    obo, _ = _write(tmp_path)
    terms = list(parse_go_obo(obo))
    assert len(terms) == 5  # the term before [Typedef] kept
    assert terms[1]["is_a"] == ["GO:0000001"]
    assert terms == list(jax_make_go.parse_go_obo(obo))


def test_graph_skips_obsolete(tmp_path):
    obo, _ = _write(tmp_path)
    g = get_go_graph(obo)["go_graph"]
    assert "GO:0000002" in g and "GO:0000004" not in g
    assert g.has_edge("GO:0000001", "GO:0000002")
    assert g.has_edge("GO:0000002", "GO:0000003")
    jg = jax_make_go.get_go_graph(obo)["go_graph"]
    assert list(g) == list(jg)
    assert {n: g.namespace[n] for n in g} == dict(jg.nodes(data="namespace"))


def test_ancestor_closure(tmp_path):
    obo, _ = _write(tmp_path)
    g = get_go_graph(obo)["go_graph"]
    bp = g.subgraph([n for n in g
                     if g.namespace[n] == "biological_process"])
    closure = ancestors_closure(bp)
    assert closure["GO:0000003"] == {"GO:0000001", "GO:0000002",
                                     "GO:0000003"}


def test_make_go_matrix_propagates(tmp_path):
    obo, gaf = _write(tmp_path)
    m = make_go_matrix(path_to_obo=obo, path_to_annotations=gaf,
                       go_branch="p")

    def at(locus, term):
        return m.values[m.index.index(locus), m.columns.index(term)]

    assert at("gene1", "GO:0000001") == 1
    assert at("gene1", "GO:0000002") == 1
    assert at("gene1", "GO:0000003") == 1
    assert at("gene2", "GO:0000003") == 0
    assert at("gene2", "GO:0000002") == 1
    assert at("gene3", "GO:0000001") == 1  # an orphan: the root
    assert (tmp_path / "go_p_matrix.txt").exists()
    with open(tmp_path / "go_p.p", "rb") as f:
        out = pickle.load(f)
    np.testing.assert_array_equal(out["go_matrix"]["values"], m.values)
    assert out["go_matrix"]["index"] == ["gene1", "gene2", "gene3"]


def _run_both(tmp_path, obo_text, gaf_text, branch="p"):
    """(port TSV bytes, JAX TSV bytes, port matrix, JAX DataFrame), each
    package writing beside its own copy of the files."""
    out = []
    for name, mod in (("port", make_go), ("jax", jax_make_go)):
        d = tmp_path / name
        d.mkdir()
        obo, gaf = _write(d, obo_text, gaf_text)
        m = mod.make_go_matrix(path_to_obo=obo, path_to_annotations=gaf,
                               go_branch=branch)
        out.append(((d / f"go_{branch}_matrix.txt").read_bytes(), m))
    (tsv, m), (jax_tsv, jm) = out
    return tsv, jax_tsv, m, jm


def synthetic_go(seed, terms=300, other=60, obsolete=10, loci=120,
                 per_locus=4, depth=8):
    """A seeded OBO and GAF: a biological-process DAG of about ``depth``
    levels (one to three parents a term, stanzas shuffled so that parents
    appear before and after their children), other-namespace and
    obsolete terms, loci annotated to a few terms each, some to none or
    twice, and comment lines."""
    rng = np.random.default_rng(seed)
    level = np.minimum(np.arange(terms) * depth // terms, depth - 1)
    ids = [f"GO:{i:07d}" for i in range(terms + other + obsolete)]
    stanzas = []
    for i in range(terms):
        parents = []
        if level[i] > 0:
            above = np.flatnonzero(level < level[i])
            parents = sorted(set(rng.choice(above, rng.integers(1, 4))))
        stanzas.append([f"id: {ids[i]}", f"name: process {i}",
                        "namespace: biological_process"]
                       + [f"is_a: {ids[p]} ! process {p}" for p in parents])
    for i in range(terms, terms + other):
        stanzas.append([f"id: {ids[i]}", f"name: component {i}",
                        "namespace: cellular_component"])
    for i in range(terms + other, len(ids)):
        stanzas.append([f"id: {ids[i]}", f"name: obsolete thing {i}",
                        "namespace: biological_process",
                        f"is_a: {ids[0]} ! process 0"])
    order = rng.permutation(len(stanzas))
    obo = "format-version: 1.2\n\n" + "".join(
        "[Term]\n" + "\n".join(stanzas[k]) + "\n\n" for k in order)
    obo += "[Typedef]\nid: part_of\nname: part of\n"
    lines = ["!gaf-version: 2.1", "!generated"]
    for g in range(loci):
        n = 0 if g % 17 == 0 else rng.integers(1, per_locus + 1)
        for t in rng.choice(len(ids), n):
            lines.append(f"DB\tL{g:04d}\tS{g}\t\t{ids[t]}\tREF\tIEA\t\tP\t\t\t"
                         "protein\ttaxon:4932\t20200101\tSGD")
            if rng.random() < 0.1:
                lines.append(lines[-1])  # a duplicate pair
    return obo, "\n".join(lines) + "\n"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tsv_bytes_equal_jax(tmp_path, seed):
    obo, gaf = synthetic_go(seed)
    tsv, jax_tsv, m, jm = _run_both(tmp_path, obo, gaf)
    assert tsv == jax_tsv
    np.testing.assert_array_equal(m.values, jm.to_numpy())
    assert m.index == list(jm.index) and m.columns == list(jm.columns)
    assert m.values.dtype == jm.to_numpy().dtype


def test_tsv_bytes_equal_jax_on_the_small_files(tmp_path):
    tsv, jax_tsv, _, _ = _run_both(tmp_path, OBO, GAF)
    assert tsv == jax_tsv


def _roots_obo():
    """Two roots: GO:1 (first in node order, unannotated) and GO:2."""
    return ("[Term]\nid: GO:1\nname: lonely root\n"
            "namespace: biological_process\n\n"
            "[Term]\nid: GO:2\nname: root two\n"
            "namespace: biological_process\n\n"
            "[Term]\nid: GO:3\nname: leaf\nnamespace: biological_process\n"
            "is_a: GO:2 ! root two\n\n"
            "[Term]\nid: GO:9\nname: component\n"
            "namespace: cellular_component\n")


def _gaf(pairs):
    return "".join(f"DB\t{g}\tX\t\t{t}\tREF\tIEA\t\tP\t\t\tprotein\t"
                   "taxon:1\t2020\tSGD\n" for g, t in pairs)


def test_empty_root_column_refused_as_jax(tmp_path):
    """The first root has no annotation, so its column was dropped, and a
    gene is an orphan: JAX's astype(int) refuses the NaN that pandas puts
    in the appended column; the port raises the same ValueError."""
    gaf = _gaf([("a", "GO:3"), ("b", "GO:9")])
    for mod in (make_go, jax_make_go):
        d = tmp_path / mod.__name__.split(".")[0]
        d.mkdir()
        obo, path = _write(d, _roots_obo(), gaf)
        with pytest.raises(ValueError, match="non-finite"):
            mod.make_go_matrix(path_to_obo=obo, path_to_annotations=path)


def test_empty_root_column_appended_as_jax(tmp_path):
    """Every gene an orphan: the dropped root's column comes back last, all
    ones, in both packages."""
    tsv, jax_tsv, m, _ = _run_both(tmp_path, _roots_obo(),
                                   _gaf([("a", "GO:9"), ("b", "GO:9")]))
    assert tsv == jax_tsv
    assert m.columns == ["GO:1"] and m.values.tolist() == [[1], [1]]


def test_cli_main(tmp_path, capsys):
    obo, gaf = _write(tmp_path)
    make_go.main(["--path-to-obo", obo, "--path-to-annotations", gaf,
                  "--go-branch", "p"])
    assert "1 loci had 0 terms" in capsys.readouterr().out
    assert (tmp_path / "go_p_matrix.txt").read_text().startswith(
        "\tGO:0000001\tGO:0000002\tGO:0000003\n")
