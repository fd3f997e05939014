"""Host graph and data layer: file loaders, layouts, attribute alignment.

Port of ``safepy_tpu/io``: the loaders of text, gpickle, MATLAB, Cytoscape
and scatter networks return a networkx-free
:class:`~safepy_tpu_torch.io.record.NetworkRecord`; the spring layouts run
on the device; the attribute reader needs no pandas. Importing it imports
no networkx or pandas and builds nothing.
"""

from safepy_tpu_torch.io.attributes import read_attributes
from safepy_tpu_torch.io.graph_arrays import (chop_and_filter,
                                              get_node_coordinates,
                                              graph_to_arrays)
from safepy_tpu_torch.io.layout import (apply_network_layout,
                                        calculate_edge_lengths)
from safepy_tpu_torch.io.matlab import load_mat
from safepy_tpu_torch.io.network import (load_network_from_cys,
                                         load_network_from_gpickle,
                                         load_network_from_mat,
                                         load_network_from_scatter,
                                         load_network_from_txt)
from safepy_tpu_torch.io.record import NetworkRecord

__all__ = [
    "load_network_from_txt",
    "load_network_from_gpickle",
    "load_network_from_mat",
    "load_network_from_cys",
    "load_network_from_scatter",
    "apply_network_layout",
    "calculate_edge_lengths",
    "read_attributes",
    "load_mat",
    "graph_to_arrays",
    "get_node_coordinates",
    "chop_and_filter",
    "NetworkRecord",
]
