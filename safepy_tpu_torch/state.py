"""Carry a JAX session's inputs across to a port session.

SAFE has no learned weights: what a session holds is its graph arrays, its
attribute matrix and names and a few scalar settings. :func:`from_numpy_state` builds a
port :class:`~safepy_tpu_torch.safe.SAFE` from those as numpy, so that the
same inputs run through both packages.
"""

from __future__ import annotations

import numpy as np

from safepy_tpu_torch.safe import SAFE

# the enrichment settings carried across, each with SAFE's default
ENRICHMENT_SETTINGS = ("enrichment_type", "enrichment_threshold",
                       "hypergeom_engine", "logsf_store", "multiple_testing",
                       "background", "attribute_sign", "node_distance_metric")
# the domain stage's settings, each with SAFE's default
DOMAIN_SETTINGS = ("attribute_enrichment_min_size",
                   "attribute_unimodality_metric", "attribute_distance_metric",
                   "attribute_distance_threshold", "cluster_engine")
# the band-storage engine's settings, each with SAFE's default, and the
# memory planner's (logsf_store is an enrichment setting too)
BAND_SETTINGS = ("apsp_mode", "band_storage_min_nodes", "band_bt_bucket",
                 "keep_node_distances", "band_relax", "band_indicator_bits",
                 "band_bits_min_bytes", "logsf_store", "hbm_budget_bytes")


def from_numpy_state(graph_arrays, node2attribute, *, neighborhood_radius,
                     random_seed, device, attribute_names=None,
                     **settings) -> SAFE:
    """A port session from what a JAX session holds as numpy.

    graph_arrays: ``sf._graph_to_arrays_cached()``, the tuple
    ``(coords, edges, lengths, weights)``; node2attribute: ``sf.node2attribute``
    (N, A) in node order; ``attribute_names``: ``sf.attributes["name"]``,
    the names the domain labels are made of (else "attribute j"); the
    scalars as on the JAX session; ``settings``: any of
    :data:`ENRICHMENT_SETTINGS`, :data:`DOMAIN_SETTINGS` and
    :data:`BAND_SETTINGS`, e.g.
    ``{k: getattr(jax_sf, k) for k in ENRICHMENT_SETTINGS}``.
    """
    unknown = sorted(set(settings) - set(ENRICHMENT_SETTINGS)
                     - set(DOMAIN_SETTINGS) - set(BAND_SETTINGS))
    if unknown:
        raise TypeError(f"unknown settings: {unknown}")
    sf = SAFE(device=device, verbose=False)
    sf.neighborhood_radius = float(neighborhood_radius)
    sf.random_seed = random_seed
    for name, value in settings.items():
        setattr(sf, name, value)
    sf.load_network(network_file=tuple(graph_arrays))
    sf.load_attributes(attribute_file=np.asarray(node2attribute))
    if attribute_names is not None:
        names = [str(n) for n in attribute_names]
        if len(names) != len(sf.attributes["name"]):
            raise ValueError(f"{len(names)} attribute names for "
                             f"{len(sf.attributes['name'])} attributes")
        sf.attributes["name"] = names
    return sf
