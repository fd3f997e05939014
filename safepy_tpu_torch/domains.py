"""Attribute -> domain assignment: top attributes, clustering, trimming.

Port of ``safepy_tpu/domains.py`` (reference ``safepy/safe.py:610-745``),
without pandas: ``attributes`` is the session's dict of per-attribute numpy
arrays, ``node2domain`` a :class:`NodeDomains`, ``domains`` a dict.

- Top attributes: at least ``min_size`` enriched neighborhoods and, for the
  'connectivity' unimodality metric, exactly one connected component of the
  enriched nodes in the network.
- Domains: average-linkage clustering of the top attributes' binary
  enrichment columns under the distance metric (jaccard by default), cut at
  ``max(Z[:, 2]) * distance_threshold``; every node's primary domain is the
  one holding most of the attributes it is enriched for (0 when none).
- Trimming: domains that are primary for fewer than ``min_size`` nodes go
  to domain 0, the rest are renumbered densely and labelled with the five
  most frequent words of their attributes' names.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
from scipy.cluster.hierarchy import fcluster, linkage
from scipy.sparse.csgraph import connected_components

from safepy_tpu_torch.io.graph_arrays import chop_and_filter
from safepy_tpu_torch.ops import domains_device as _dd

#: the GEMM engine's threshold under 'auto' (``domains.py:96``): below it
#: scipy's own pdist is cheap
CLUSTER_ENGINE_MIN_TOP = 96


@dataclass
class NodeDomains:
    """The JAX package's ``node2domain`` DataFrame as arrays: one count
    column per domain id and each node's primary domain and its NES.
    ``n2d[d]`` reads the count column of domain id ``d``, and
    ``n2d["primary_domain"]`` / ``n2d["primary_nes"]`` those arrays, as on
    the DataFrame."""

    domains: np.ndarray         # (D,) int64 domain ids, sorted
    counts: np.ndarray          # (N, D) f64 enriched-attribute counts
    primary_domain: np.ndarray  # (N,) int64
    primary_nes: np.ndarray     # (N,) f64

    def __getitem__(self, key):
        if key in ("primary_domain", "primary_nes"):
            return getattr(self, key)
        hit = np.flatnonzero(self.domains == key)
        if len(hit) != 1:
            raise KeyError(key)
        return self.counts[:, hit[0]]


def define_top_attributes(attributes, nes_binary, edges, num_nodes, *,
                          unimodality_metric="connectivity", min_size=10,
                          verbose=True):
    """Mark the top attributes in the attributes dict, in place
    (``domains.py:29-90``). ``nes_binary``: the (N, A) indicator, dense or
    a scipy CSC matrix (whose column indices are the enriched nodes);
    ``edges`` (E, 2): the network in node order."""
    logging.info("Criteria for top attributes:")
    logging.info("- minimum number of enriched neighborhoods: %d" % min_size)
    logging.info("- region-specific distribution of enriched neighborhoods as "
                 "defined by: %s" % unimodality_metric)

    top = np.asarray(attributes["num_neighborhoods_enriched"]) >= min_size
    if unimodality_metric == "connectivity":
        a = len(top)
        num_components = np.zeros(a, np.int64)
        sizes = np.full(a, None, dtype=object)
        num_large = np.zeros(a, np.int64)
        # one sparse adjacency, then each attribute's induced subgraph
        edges = np.asarray(edges, np.int64).reshape(-1, 2)
        rows, cols = edges[:, 0], edges[:, 1]
        adj = sp.csr_matrix((np.ones(2 * len(edges)),
                             (np.concatenate([rows, cols]),
                              np.concatenate([cols, rows]))),
                            shape=(num_nodes, num_nodes))
        sparse_input = sp.issparse(nes_binary)
        for j in np.flatnonzero(top):
            if sparse_input:
                idx = nes_binary.indices[
                    nes_binary.indptr[j]:nes_binary.indptr[j + 1]]
            else:
                idx = np.flatnonzero(nes_binary[:, j] > 0)
            if len(idx) == 0:
                sizes[j] = np.array([])
                continue
            ncomp, labels = connected_components(adj[idx][:, idx],
                                                 directed=False)
            comp = np.sort(np.bincount(labels))[::-1]
            num_components[j] = ncomp
            sizes[j] = comp
            num_large[j] = np.sum(comp >= min_size)
        top[num_components > 1] = False
        attributes.update(num_connected_components=num_components,
                          size_connected_components=sizes,
                          num_large_connected_components=num_large)
    attributes["top"] = top

    if verbose:
        logging.info("Number of top attributes: %d" % int(np.sum(top)))
    return attributes


def uses_gemm(cluster_engine: str, distance_metric: str, num_top: int) -> bool:
    """Does define_domains take the intersection-GEMM engine
    (``domains.py:133-135``)?"""
    return (cluster_engine == "gemm"
            or (cluster_engine == "auto" and distance_metric == "jaccard"
                and num_top >= CLUSTER_ENGINE_MIN_TOP))


def define_domains(attributes, nes, nes_binary, *, distance_metric="jaccard",
                   distance_threshold=0.75, verbose=True,
                   cluster_engine="auto", intersections=None,
                   nes_binary_dev=None, nes_dev=None, device="cuda"):
    """Cluster the top attributes into domains and give every node a primary
    domain (``domains.py:99-205``). Returns (attributes, node2domain):
    attributes gains 'domain'.

    ``cluster_engine``: 'scipy' hands the binary columns to scipy's linkage;
    'gemm' builds the same condensed jaccard distances from the
    intersection GEMM and computes the node aggregates on ``device`` too;
    'auto' takes 'gemm' for jaccard at :data:`CLUSTER_ENGINE_MIN_TOP` top
    attributes and more. ``intersections``: a precomputed (A, A) count
    matrix. ``nes_binary_dev`` / ``nes_dev``: the session's device tensors.
    ``nes`` / ``nes_binary`` may be zero-argument callables returning the
    host matrices: the GEMM engine reads the device copies and never calls
    them when those are given."""
    get_nes = nes if callable(nes) else (lambda: nes)
    get_binary = nes_binary if callable(nes_binary) else (lambda: nes_binary)
    top_mask = np.asarray(attributes["top"], bool)
    if top_mask.sum() < 2:
        raise ValueError("define_domains requires at least 2 top attributes "
                         f"(got {int(top_mask.sum())}).")
    use_gemm = uses_gemm(cluster_engine, distance_metric, int(top_mask.sum()))
    if use_gemm and distance_metric != "jaccard":
        raise ValueError("cluster_engine='gemm' serves the jaccard metric "
                         f"only (got {distance_metric!r})")

    if use_gemm:
        if intersections is None:
            intersections = _dd.enrichment_intersections(
                get_binary() if nes_binary_dev is None else nes_binary_dev,
                device)
        top_idx = np.flatnonzero(top_mask)
        Z = linkage(_dd.jaccard_condensed_from_counts(
            intersections[np.ix_(top_idx, top_idx)]), method="average")
    else:
        nes = get_nes()
        nes_binary = get_binary()
        Z = linkage(nes_binary[:, top_mask].T, method="average",
                    metric=distance_metric)
    domains = fcluster(Z, np.max(Z[:, 2] * distance_threshold),
                       criterion="distance")

    domain_of_attr = np.zeros(len(top_mask), np.int64)
    domain_of_attr[top_mask] = domains
    attributes["domain"] = domain_of_attr
    unique_domains = np.unique(domain_of_attr)

    if use_gemm:
        counts, max_nes = _dd.domain_aggregates(
            get_binary() if nes_binary_dev is None else nes_binary_dev,
            get_nes() if nes_dev is None else nes_dev,
            np.searchsorted(unique_domains, domain_of_attr),
            len(unique_domains), device)
        counts = counts.astype(np.float64)  # the reference's f64 groupby-sum
    else:
        # counts[node, d]: the domain-d attributes the node is enriched for
        counts = np.stack([nes_binary[:, domain_of_attr == d].sum(axis=1)
                           for d in unique_domains], axis=1).astype(np.float64)
        # the largest NES of each domain per node, for the primary domain
        with np.errstate(invalid="ignore"):
            max_nes = np.stack(
                [np.nanmax(np.where(np.isnan(nes[:, domain_of_attr == d]),
                                    -np.inf, nes[:, domain_of_attr == d]),
                           axis=1, initial=-np.inf)
                 for d in unique_domains], axis=1)

    # the first of the largest nonzero-domain counts (pandas idxmax), 0
    # where a node is enriched for no top attribute
    nonzero = np.flatnonzero(unique_domains != 0)
    t = counts[:, nonzero]
    primary = unique_domains[nonzero][np.argmax(t, axis=1)]
    primary[t.max(axis=1) == 0] = 0
    # a node of domain 0 takes domain 0's largest NES where 0 is a domain
    # (every non-top attribute), else NES 0 (every attribute clustered)
    rows = np.arange(counts.shape[0])
    nes0 = (max_nes[:, 0] if unique_domains[0] == 0
            else np.zeros(counts.shape[0]))
    primary_nes = np.where(
        primary == 0, nes0,
        max_nes[rows, np.searchsorted(unique_domains, primary)])

    if verbose:
        _, per_domain = np.unique(domain_of_attr[domain_of_attr > 0],
                                  return_counts=True)
        logging.info("Number of domains: %d (containing %d-%d attributes)"
                     % (len(np.unique(domains)), per_domain.min(),
                        per_domain.max()))
    return attributes, NodeDomains(unique_domains, counts, primary,
                                   primary_nes)


def trim_domains(attributes, node2domain: NodeDomains, *, min_size=10,
                 verbose=True):
    """Drop the domains that are primary for fewer than ``min_size`` nodes,
    renumber densely and label the survivors (``domains.py:208-254``).
    Returns (attributes, node2domain, domains): domains is
    ``{"id": ids, "label": labels}``, one row for each domain id the
    attributes hold, in order.

    The trimmed domains' count columns fold into domain 0, where their
    attributes go, and the rest take their new ids: the JAX package's fix of
    the reference, which keeps the original ids (PARITY.md)."""
    dom = np.asarray(attributes["domain"], np.int64)
    domain_counts = np.zeros(int(dom.max()) + 1, dtype=int)
    ids, per_id = np.unique(node2domain.primary_domain, return_counts=True)
    domain_counts[ids.astype(int)] = per_id
    to_remove = np.flatnonzero(domain_counts < min_size)

    dom = np.where(np.isin(dom, to_remove), 0, dom)
    gone = np.isin(node2domain.primary_domain, to_remove)
    primary = np.where(gone, 0, node2domain.primary_domain)
    primary_nes = np.where(gone, 0.0, node2domain.primary_nes)

    kept = np.unique(dom)
    if kept[0] != 0:  # all attributes clustered; nodes may still carry 0
        kept = np.concatenate([[0], kept])
    dom = np.searchsorted(kept, dom)
    primary = np.searchsorted(kept, primary)

    cols, counts = node2domain.domains, node2domain.counts
    folded = np.isin(cols, to_remove) & (cols != 0)
    if folded.any():
        if cols[0] != 0:
            cols = np.concatenate([[0], cols])
            counts = np.concatenate([np.zeros((len(counts), 1)), counts],
                                    axis=1)
            folded = np.concatenate([[False], folded])
        counts = counts.copy()
        counts[:, 0] = counts[:, 0] + counts[:, folded].sum(axis=1)
        cols, counts = cols[~folded], counts[:, ~folded]
    attributes["domain"] = dom

    names = attributes["name"]
    ids = np.unique(dom)
    labels = [chop_and_filter([names[j] for j in np.flatnonzero(dom == d)])
              for d in ids]
    if verbose:
        logging.info("Removed %d domains because they were the top choice for "
                     "less than %d neighborhoods." % (len(to_remove), min_size))
    return (attributes,
            NodeDomains(np.searchsorted(kept, cols), counts, primary,
                        primary_nes),
            {"id": ids, "label": labels})
