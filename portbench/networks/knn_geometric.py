"""``knn_geometric``: a geometric stand-in for a biological network (the
configuration's ``network``: ``nodes``, ``knn``, ``edge_budget``), drawn by
``generators.build_network`` from the run's seed."""

from types import SimpleNamespace

from portbench import generators


def build(network: dict, seed: int) -> SimpleNamespace:
    """The arrays both sides get: coords (n, 2), edges (E, 2), lengths
    (E,), weights (E,); ``network_file``, what ``SAFE.load_network`` takes."""
    coords, edges, lengths, weights = generators.build_network(
        int(network["nodes"]), int(network["knn"]),
        network.get("edge_budget"), seed)
    return SimpleNamespace(coords=coords, edges=edges, lengths=lengths,
                           weights=weights,
                           network_file=(coords, edges, lengths, weights))
