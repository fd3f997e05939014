"""What the plots show, computed without matplotlib.

The host numpy half of ``safepy_tpu/plotting.py`` that reads the port's
objects: the network's edges and labels, the domains table's rows, the
domain-mixture node colors and the attribute selection. ``plotting``
draws them with matplotlib; this module imports none, so the plot data
can be computed and checked where matplotlib is not installed (the card's
machine).
"""

from __future__ import annotations

import numpy as np

from safepy_tpu_torch.io.record import NetworkRecord


def edge_index(G) -> np.ndarray:
    """(E, 2) node positions of the edges in ``Graph.edges()`` order, of a
    :class:`NetworkRecord` or a networkx graph."""
    if isinstance(G, NetworkRecord):
        return G.edges
    index = {n: i for i, n in enumerate(G)}
    return np.asarray([(index[u], index[v]) for u, v in G.edges()],
                      np.int64).reshape(-1, 2)


def node_labels(G) -> dict:
    """{label: node} of the nodes that carry one (``nx.get_node_attributes(
    graph, "label")`` inverted, ``plotting.py:264``)."""
    if isinstance(G, NetworkRecord):
        labels = G.nodes.get("label")
        if labels is None:
            return {}
        return {lab: i for i, lab in enumerate(labels) if lab is not None}
    return {d["label"]: u for u, d in G.nodes(data=True) if "label" in d}


def isna(v) -> bool:
    return v is None or (isinstance(v, (float, np.floating)) and np.isnan(v))


def domain_row(domains: dict, domain) -> int:
    """The row of domain id ``domain`` in the domains table (``.loc``)."""
    hit = np.flatnonzero(np.asarray(domains["id"]) == domain)
    if len(hit) != 1:
        raise KeyError(domain)
    return int(hit[0])


def domain_mixture_colors(sf, domain2rgb):
    """Node color = enrichment-count-weighted mixture of its domains' colors,
    brightness normalized to mean 0.1 (``plotting.py:334-366``): the
    counts are node2domain's while it derives from the current indicator
    (its serial is the enrichment's), else the host sums of the int8
    indicator."""
    domain_of_attr = np.asarray(sf.attributes["domain"])
    unique_domains = np.sort(np.unique(domain_of_attr))
    n2d = getattr(sf, "node2domain", None)
    fresh = (getattr(sf, "_node2domain_serial", None) is not None
             and sf._node2domain_serial == getattr(sf, "_enrichment_serial",
                                                   None))
    if n2d is not None and fresh \
            and np.isin(unique_domains, n2d.domains).all():
        counts = np.stack([n2d[d] for d in unique_domains], axis=1)
    else:
        nes_binary = sf._nes_binary_small()  # int8; sums promote to int64
        counts = np.stack([nes_binary[:, domain_of_attr == d].sum(axis=1)
                           for d in unique_domains], axis=1)
    total = counts.sum(axis=1, keepdims=True)

    with np.errstate(divide="ignore", invalid="ignore"):
        mixture = (counts @ domain2rgb[:counts.shape[1]]) / total

    brightness = np.sum(mixture, axis=1)
    mixture[np.isnan(brightness) | np.isinf(brightness), :] = [0, 0, 0, 0]

    mean_rgb = np.nanmean(np.ravel(mixture[:, :-1]))
    gain = 0.1 / mean_rgb if mean_rgb else 1.0
    if gain > 1:
        mixture = mixture * gain
    return np.clip(mixture, None, 1)


def select_attributes(sf, attributes, top_attributes_only, seed):
    """Count / name / list-of-names selection (``plotting.py:471-489``): a
    count at least the candidates' returns the candidates' ids."""
    names = list(sf.attributes["name"])
    candidates = np.arange(len(names))
    if top_attributes_only:
        candidates = candidates[np.asarray(sf.attributes["top"], bool)]

    if isinstance(attributes, int):
        if attributes < len(candidates):
            return np.random.default_rng(seed).choice(candidates, attributes,
                                                      replace=False)
        return candidates
    if isinstance(attributes, str):
        return [names.index(attributes)]
    return [names.index(a) for a in attributes]
