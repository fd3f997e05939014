"""The SAFE facade of the port.

Port of the ``safepy_tpu/safe.py`` facade for the enrichment workflows: load
a network and an attribute matrix, then either ``run_pipeline`` (fused) or
the stages ``define_neighborhoods`` and ``compute_pvalues`` compute
neighborhoods and enrichment, and set ``neighborhoods``, ``node_distances``,
``pvalues_pos``, ``nes`` and ``nes_binary`` (plus ``ns``, ``pvalues_neg`` and
the counts of the permutation null) as the JAX facade does.

- Quantitative attributes take the two-sided permutation null, binary 0/1
  attributes the one-sided hypergeometric test ('auto'), over dense,
  banded-window or band-storage neighborhoods. Over band storage the binary
  test takes the class table (``table-band``), else the f64 tail loop in
  host-driven column chunks (``hostchunks-band``) or whole
  (``loop-band``), fused or staged (``safe.py:1327-1390, 1893-2047``).
- The neighborhood engine is chosen in the JAX facade's order
  (``safe.py:1702-1712``): band storage (O(N W) memory, ``apsp_mode='band'``
  or ``'auto'`` at ``band_storage_min_nodes`` and above when the band beats
  dense storage), then the certified banded window, then the dense
  Floyd-Warshall. The band is relaxed by the FW, or with
  ``band_relax='bf'`` by the sparse Bellman-Ford, which gives way to the FW
  when it runs out of rounds (``_band_relax_used`` says which ran). The
  euclidean metric takes the same band storage, built from the coordinates
  (``safe.py:443-466, 1795``), else the dense distance matrix. The indicator
  band is bit-packed with ``band_indicator_bits`` (``'auto'``: once the int8
  band reaches ``band_bits_min_bytes``; on the euclidean band only without
  kept distances).
- ``run_pipeline`` runs the stages for ``background='network'`` and for the
  euclidean metric, except a quantitative run over the euclidean band,
  which is fused, as JAX does (``safe.py:1664-1684``).
- FDR (``multiple_testing``) adjusts log-survival on the device in the fused
  binary path, linear p-values in the staged one and in the null.
- The domain stage (``safe.py:2243-2287``): ``define_top_attributes``,
  ``define_domains`` and ``trim_domains`` cluster the co-enriched
  attributes into domains (``domains.py``); the jaccard intersections, the
  node-to-domain counts and the per-domain NES maxima are computed on the
  session's device (``ops/domains_device.py``).
- With ``mesh`` set to a DeviceMesh (``parallel.make_mesh``, one device a
  rank, every rank running the same calls; ``safe.py:488-531, 1252-1266,
  1616-1624, 1700-1785``): a ``data`` axis row-shards the dense FW, a
  (``row``, ``col``) mesh shards it 2-D, and then no banded window is
  taken; the permutation null splits over every mesh axis (the stages on
  a ``perm`` axis), its count rounded up to a multiple of the device
  count; the hypergeometric columns split over an ``attr`` axis. Band
  storage takes only a mesh of one ``data`` axis, and never in the
  stages: the row-sharded band engine (``parallel.band_sharded``) runs
  the quantitative run (the band bit-packed where selected), band GO
  (``table-band-sharded``, or the f64 tail loop ``loop-band-sharded``,
  planned per rank first, ``hbm.band_go_shard_hbm_plan``) and the
  euclidean band pipeline (``safe.py:1831-1843, 1974-2082``). Every rank
  gets the same global results, the bands and (n, A) matrices in host
  memory (JAX keeps them row-sharded over the devices); a later stage that
  computes on them uploads what it reads to ``device``.
- Band GO runs are planned before they allocate (``hbm.py``): the
  log-survival's residency (``logsf_store``: device f32, f16 or host;
  'auto' the first that fits ``hbm_budget_bytes``, or the device), the
  column-chunked operand prep past the budget, and a ``ValueError``
  carrying the plan when nothing fits (``_hbm_plan_last``).

The session is built as JAX's is (``safe.py:80-272``): the package
defaults of ``safe_default.ini``, then the user INI (``config.py``); the
network and attribute files are read by ``io`` (``load_network``,
``load_attributes``, ``safe.py:282-419``; a ``.scatter`` input also builds
``graph_euclidean``, which ``define_top_attributes`` uses for
connectivity), and ``print_output_files`` writes the TSV reports
(``output.py``).

Differences of idiom: the session has a keyword-only ``device``
(``"cuda"`` by default, ``"cpu"`` for tests); ``graph`` is an
``io.NetworkRecord`` and ``nodes`` a dict of arrays, not networkx and
pandas objects; ``load_network`` also takes the ``(coords, edges, lengths,
weights)`` arrays, and networkx and pandas are used only when the caller
hands in their objects or asks for networkx's layouts; the null and
``run_pipeline`` take explicit permutations (``perm_idx``).
"""

from __future__ import annotations

import hashlib
import logging
import os
import pickle
import sys
from pathlib import Path

import numpy as np
import torch

from safepy_tpu_torch import config as _config
from safepy_tpu_torch import domains as _domains
from safepy_tpu_torch import hbm as _hbm
from safepy_tpu_torch import output as _output
from safepy_tpu_torch import pipeline as _pipe
from safepy_tpu_torch import profiling as _prof
from safepy_tpu_torch import transfer as _transfer
from safepy_tpu_torch.debug import validate_attributes
from safepy_tpu_torch.io import attributes as _attr_io
from safepy_tpu_torch.io import network as _net_io
from safepy_tpu_torch.io.graph_arrays import (get_node_coordinates,
                                              graph_to_arrays)
from safepy_tpu_torch.io.record import NetworkRecord, graph_edges
from safepy_tpu_torch.ops import apsp_banded as _banded
from safepy_tpu_torch.ops import apsp_bandstore as _bst
from safepy_tpu_torch.ops import domains_device as _dd
from safepy_tpu_torch.ops import enrich_band as _eb
from safepy_tpu_torch.ops import fdr as _fdr
from safepy_tpu_torch.ops import hypergeom as _hyper
from safepy_tpu_torch.ops import hypergeom_table as _htab
from safepy_tpu_torch.ops import neighborhoods as _nbr
from safepy_tpu_torch.ops._device import on_device
from safepy_tpu_torch.ops.apsp_bandstore import BandedMatrix
from safepy_tpu_torch.parallel.mesh import fw_sharding, mesh_names
# the module, not its run_permutations: this module defines the reference's
# run_permutations(arg_tuple) below
from safepy_tpu_torch.ops import permutation as _perm
from safepy_tpu_torch.ops.score import (check_fp32_matmul,
                                        compute_neighborhood_score)


def _nes_from_logsf_host(logsf32: np.ndarray) -> np.ndarray:
    """NES from a host f32 log-survival as ``SAFE._nes_device()`` derives
    it on the device: ``-logsf / ln 10`` in f64, rounded to f32, as f64
    (``safe.py:72-77, 2174-2178``)."""
    with np.errstate(invalid="ignore"):
        return (-logsf32.astype(np.float64) / np.log(10.0)).astype(
            np.float32).astype(np.float64)


def _column_index(j, num_columns: int) -> int:
    """``j`` checked against the columns on the host: a device slice out of
    range raises a device assert, where the host matrix raises this
    ``IndexError`` (``safe.py:2186-2199``)."""
    j = int(j)
    if not 0 <= j < num_columns:
        raise IndexError(f"attribute index {j} out of range "
                         f"[0, {num_columns})")
    return j


def _band_to_numpy(bm):
    """A band wrapper with its data as numpy, through
    :meth:`BandedMatrix.to_host`."""
    if isinstance(bm.data, np.ndarray):
        return bm
    host = bm.to_host()
    host.data = host.data.numpy()
    return host


# the defaults of what a session pickled before it existed lacks
# (safe.py:1162-1182)
_PICKLE_DEFAULTS = dict(
    cluster_engine="auto", logsf_store="auto", band_bt_bucket=4,
    keep_node_distances=True, band_relax="auto", band_indicator_bits="auto",
    band_bits_min_bytes=4 * 10 ** 9, hypergeom_engine="auto",
    matmul_precision="highest", mesh=None, graph_euclidean=None,
    _domains_inter_cache=None, _nes_binary_i8_np=None, _nes_binary_csc=None,
    _logsf_np=None, _nes_from_logsf=False, _band_operands_cache=None,
    _attr_serial=0, _enrichment_serial=0, _node2domain_serial=None,
    _band_relax_used=None, _hypergeom_engine_used=None,
    hbm_budget_bytes=None, _hbm_plan_last=None)


class SAFE:
    """One SAFE analysis on one torch device."""

    def __init__(self, path_to_ini_file="", path_to_safe_data=None,
                 verbose: bool = True, *, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("SAFE(device='cuda') needs a CUDA device and "
                               "none is available; pass device='cpu' to run "
                               "on the host")
        self.verbose = verbose

        # the INI-backed settings (read_config below): the package
        # defaults' DEFAULT section, from which a failed check restores
        self.default_config = None
        self.path_to_safe_data = path_to_safe_data
        self.path_to_network_file = None
        self.view_name = None
        self.path_to_attribute_file = None
        self.layout_algorithm = "spring_embedded"
        self.output_dir = ""
        # the loaded network (an io.record.NetworkRecord), the euclidean
        # pseudo-network of a scatter input, and the node table (id, key,
        # label; after print_output_files the node-properties table)
        self.graph = None
        self.graph_euclidean = None
        self.nodes = None

        # 'auto' = band storage at band_storage_min_nodes and above (when
        # the band is at most half the dense bytes), else the banded window
        # when the geometric certificate holds, else the dense FW; 'full' =
        # always the dense FW; 'band' = always band storage
        self.apsp_mode = "auto"
        self.band_storage_min_nodes = 16384
        # the band-storage plan rounds bt (= band // 128 + 1) up to a
        # multiple of this before deciding whether the band beats dense
        # storage (safe.py:125-138); 0 or None: the raw band. The band only
        # widens, so the in-radius results do not change.
        self.band_bt_bucket = 4
        # False drops the f32 distance band of a band-storage run as soon as
        # its indicator exists (node_distances is then None for the run)
        self.keep_node_distances = True
        # the band relax: 'bf' = the sparse Bellman-Ford (falling back to the
        # FW when it runs out of rounds); anything else = the FW
        self.band_relax = "auto"
        # bit-pack the indicator band: True, False, or 'auto' = once the int8
        # band reaches band_bits_min_bytes
        self.band_indicator_bits = "auto"
        self.band_bits_min_bytes = 4 * 10 ** 9
        self.node_key_attribute = "label_orf"
        self.attribute_sign = "both"
        self.node_distance_metric = "shortpath_weighted_layout"
        # a label for the log only, as in the JAX facade (safe.py:186 and
        # safe_default.ini's neighborhoodRadiusType)
        self.neighborhood_radius_type = "diameter"
        self.neighborhood_radius = 0.1
        self.background = "attribute_file"
        self.num_permutations = 1000
        self.multiple_testing = False
        self.neighborhood_score_type = "sum"
        self.enrichment_type = "auto"
        # hypergeometric survival engine of the fused binary path: 'auto' =
        # the class table (ops/hypergeom_table.py) for binary annotations
        # within budget, the per-cell f64 tail loop otherwise; 'table' /
        # 'loop' force one (safe.py:194-197)
        self.hypergeom_engine = "auto"
        # where the band class table keeps its (N, A) log-survival
        # (safe.py:161): 'device' f32, 'f16' (indicator and counts decided
        # in f64 before the rounding, so exact), 'host' (numpy, bitwise
        # 'device'); 'auto' takes the first that the memory plan admits
        # (hbm.py). A forced mode the plan refuses raises.
        self.logsf_store = "auto"
        # the memory plan's budget in bytes; None = ask the device
        # (hbm.device_hbm_budget). The band GO runs raise a ValueError
        # carrying the plan before the operand prep when nothing fits.
        self.hbm_budget_bytes = None
        self._hbm_plan_last = None  # the last plan, for the caller to read
        self.enrichment_threshold = 0.05
        self.enrichment_max_log10 = 16
        self.attribute_enrichment_min_size = 10
        self.random_seed = None
        self.matmul_precision = "highest"
        # a DeviceMesh with one "data" axis shards the band-storage engine
        # over its ranks (the caller initializes torch.distributed)
        self.mesh = None

        self.attribute_unimodality_metric = "connectivity"
        self.attribute_distance_metric = "jaccard"
        self.attribute_distance_threshold = 0.75
        # 'auto' | 'gemm' | 'scipy': how define_domains builds the jaccard
        # linkage input ('auto' = the intersection GEMM at
        # domains.CLUSTER_ENGINE_MIN_TOP top attributes and more)
        self.cluster_engine = "auto"
        # the (A, A) intersection counts of the device indicator, reused
        # when the stage re-clusters at another threshold
        self._domains_inter_cache = None
        self.domains = None
        self.node2domain = None

        self._graph_arrays = None
        self._num_nodes = None
        self._d0_cache = {}
        self._banded_cache = {}
        self._bandstore_cache = {}

        self.attributes = None
        self.node2attribute = None
        self._n2a_dev = None
        self._num_other_cache = None
        # the band binary engines' device operands, keyed on the attribute
        # load (_attr_serial) and the banded order
        self._attr_serial = 0
        self._band_operands_cache = None

        # which APSP engine and window the last neighborhoods took, the band
        # relax of a band-storage run ("fw", "bf" or "bf->fw"), and which
        # hypergeometric engine served the last binary enrichment
        self.apsp_engine_used = None
        self.window_used = None
        self._band_relax_used = None
        self._hypergeom_engine_used = None
        self._neighborhoods_dev = None
        self._neighborhoods_np = None
        self._node_distances_dev = None
        self._node_distances_np = None
        self.ns = None
        self.counts_neg = None
        self.counts_pos = None
        self.pvalues_neg = None
        # the binary results stay on the device (f32 log-survival, f32 NES
        # or none, int8 indicator) until read: see the lazy views
        self._pvalues_pos_np = None
        self._logsf_dev = None
        # the f32 log-survival on the host: what a pickle keeps of
        # _logsf_dev, from which pvalues_pos and a deferred NES derive
        self._logsf_np = None
        self._nes_np = None
        self._nes_dev = None
        self._nes_from_logsf = False
        self._nes_binary_np = None
        self._nes_binary_dev = None
        # the device indicator's int8 download and its CSC view, made on
        # first use by the domain stage
        self._nes_binary_i8_np = None
        self._nes_binary_csc = None
        # (indicator, enriched counts) of a device run, for
        # _update_binary_enrichment
        self._nes_binary_pending = None
        # bumped by each new indicator; define_domains stamps node2domain
        # with it, so the plots know whether its counts are current
        self._enrichment_serial = 0
        self._node2domain_serial = None

        self.read_config(path_to_ini_file,
                         path_to_safe_data=self.path_to_safe_data)
        self.validate_config()

    # ---------------------------------------------------------------- config

    def read_config(self, path_to_ini_file, path_to_safe_data=None):
        """The package defaults, then the user INI (``safe.py:259-269``)."""
        cfg, defaults = _config.read_config(path_to_ini_file,
                                            path_to_safe_data)
        self.default_config = defaults
        for field in ("path_to_safe_data", "path_to_network_file",
                      "path_to_attribute_file", "attribute_sign",
                      "background", "layout_algorithm",
                      "node_distance_metric", "neighborhood_radius_type",
                      "neighborhood_radius", "random_seed",
                      "attribute_unimodality_metric",
                      "attribute_distance_metric",
                      "attribute_distance_threshold", "output_dir"):
            setattr(self, field, getattr(cfg, field))

    def validate_config(self):
        """The settings checks of ``config.validate_config``
        (``config.py:140-193``): an offending setting is restored to its
        default before the ``ValueError``. Then the port's own check of
        ``apsp_mode``, which JAX does not check."""
        _config.validate_config(self, self.default_config)
        if self.apsp_mode not in ("auto", "full", "band"):
            bad, self.apsp_mode = self.apsp_mode, "auto"
            raise ValueError(f"unknown apsp_mode: {bad!r}")

    _validate = validate_config

    # --------------------------------------------------------------- network

    def load_network(self, **kwargs):
        """Load the network (``safe.py:282-352``): from the file of the INI's
        ``networkfile`` or of ``network_file=`` (joined under
        ``path_to_safe_data``), chosen by its first suffix (.txt / .tsv with
        the ``layout_algorithm`` layout on the session's device, .mat,
        .gpickle, .cys, .scatter); or from a networkx graph with nodes
        0..N-1 carrying 'x', 'y' and the node key attribute, and 'length' on
        its edges; or from the tuple ``(coords, edges, lengths, weights)``
        that the JAX facade caches (``_graph_to_arrays_cached``,
        ``safe.py:666``), which carries no node keys. ``view_name`` and
        ``node_key_attribute`` override the settings of those names.

        ``graph`` becomes an :class:`~safepy_tpu_torch.io.NetworkRecord`,
        its key column copied into ``key``, and ``nodes`` the dict of the
        ``id``, ``key`` and ``label`` arrays."""
        if "network_file" in kwargs:
            nf = kwargs.pop("network_file")
            if self.path_to_safe_data is None or not isinstance(nf, str):
                self.path_to_network_file = nf
            else:
                self.path_to_network_file = os.path.join(
                    self.path_to_safe_data, nf)
        if "view_name" in kwargs:
            self.view_name = kwargs["view_name"]
        if kwargs.get("node_key_attribute") is not None:
            self.node_key_attribute = kwargs["node_key_attribute"]

        self.validate_config()
        source = self.path_to_network_file
        self.graph_euclidean = None
        if isinstance(source, tuple):
            coords, edges, lengths, weights = source
            if coords is None:
                raise ValueError("network arrays need node coordinates")
            coords = np.asarray(coords, np.float64)
            edges = np.asarray(edges, np.int64).reshape(-1, 2)
            edge_data = {"weight": (np.ones(len(edges)) if weights is None
                                    else np.asarray(weights, np.float64))}
            if lengths is not None:
                edge_data["length"] = np.asarray(lengths, np.float64)
            self.graph = NetworkRecord(len(coords), edges, {
                "x": coords[:, 0].copy(), "y": coords[:, 1].copy()},
                edge_data)
            self.nodes = None
        else:
            if isinstance(source, NetworkRecord):
                self.graph = source
            elif isinstance(source, str):
                self.graph = self._read_network_file(source)
            else:
                nx = sys.modules.get("networkx")
                if nx is None or not isinstance(source, nx.Graph):
                    raise TypeError(
                        "network_file must be a path, a networkx Graph or a "
                        "(coords, edges, lengths, weights) tuple, got "
                        f"{type(source).__name__}")
                self.graph = NetworkRecord.from_networkx(source)
            keys = self.graph.node_attribute(self.node_key_attribute)
            if keys is None:
                raise ValueError(
                    "The specified node key attribute (%s) does not exist in "
                    "this network. These attributes exist instead: %s. Set "
                    "node_key_attribute to one of these options."
                    % (self.node_key_attribute,
                       ", ".join(map(str, self.graph.nodes))))
            self.graph.nodes["key"] = keys
            self.nodes = {"id": np.arange(self.graph.num_nodes), "key": keys,
                          "label": self.graph.nodes.get("label")}
        self._num_nodes = self.graph.num_nodes
        self._graph_arrays = graph_to_arrays(self.graph)
        self._d0_cache = {}
        self._banded_cache = {}
        self._bandstore_cache = {}

    def _read_network_file(self, path):
        """The record of a network file, by its first suffix."""
        if not os.path.exists(path):
            raise AssertionError(path)
        ext = Path(path).suffixes[0]
        if self.verbose:
            logging.info("Loading network from %s" % path)
        if ext == ".mat":
            return _net_io.load_network_from_mat(path, verbose=self.verbose)
        if ext == ".gpickle":
            return _net_io.load_network_from_gpickle(path,
                                                     verbose=self.verbose)
        if ext in (".txt", ".tsv"):
            return _net_io.load_network_from_txt(
                path, layout=self.layout_algorithm,
                node_key_attribute=self.node_key_attribute,
                seed=self.random_seed, verbose=self.verbose,
                device=self.device)
        if ext == ".cys":
            return _net_io.load_network_from_cys(
                path, view_name=self.view_name, verbose=self.verbose)
        if ext == ".scatter":
            graph = _net_io.load_network_from_scatter(
                path, node_key_attribute=self.node_key_attribute,
                verbose=self.verbose)
            self.graph_euclidean = self._build_graph_euclidean(graph)
            return graph
        raise ValueError(f"unsupported network file extension: {ext}")

    def _build_graph_euclidean(self, graph):
        """The pseudo-network linking the nodes closer than the
        neighborhood radius, which the connectivity check of the top
        attributes reads on an edgeless scatter input
        (``safe.py:354-375``): the strict ``<`` of the dense distance
        matrix on the device (self-loops included, as networkx builds it)
        up to 20,000 nodes, a KD-tree radius query above."""
        coords = get_node_coordinates(graph)
        nr = self.neighborhood_radius * (coords.ravel().max()
                                         - coords.ravel().min())
        n = len(coords)
        if n > 20000:
            from scipy.spatial import cKDTree
            pairs = cKDTree(coords).query_pairs(nr, output_type="ndarray")
            d = np.hypot(coords[pairs[:, 0], 0] - coords[pairs[:, 1], 0],
                         coords[pairs[:, 0], 1] - coords[pairs[:, 1], 1])
            edges, _, _ = graph_edges(pairs[d < nr], n)
        else:
            dist = _nbr.euclidean_distance_matrix(torch.as_tensor(
                coords, dtype=torch.float64, device=self.device))
            pairs = torch.nonzero(dist < nr).cpu().numpy()
            edges, _, _ = graph_edges(pairs, n)
        return NetworkRecord(n, edges)

    def _arrays(self):
        """The graph's (coords, edges, lengths, weights), rebuilt from
        ``graph`` where a pickle or a checkpoint left none."""
        if self._graph_arrays is None and self.graph is not None:
            self._graph_arrays = graph_to_arrays(self.graph)
            self._num_nodes = self.graph.num_nodes
        return self._graph_arrays

    def save(self, output_file="", **kwargs):
        """Pickle the session (``safe.py:274-278``); see
        :meth:`__getstate__` for what the file holds."""
        if not output_file:
            output_file = os.path.join(os.getcwd(), "safe_output.p")
        with open(output_file, "wb") as handle:
            pickle.dump(self, handle)

    def save_network(self, **kwargs):
        """Pickle the network record (``safe.py:377``)."""
        output_file = kwargs.get(
            "output_file",
            os.path.join(os.getcwd(),
                         str(self.path_to_network_file) + ".gpickle"))
        with open(output_file, "wb") as f:
            pickle.dump(self.graph, f)

    # ------------------------------------------------------------ attributes

    def load_attributes(self, **kwargs):
        """Load node attributes (``safe.py:386-419``): from the file of the
        INI's ``annotationfile`` or of ``attribute_file=`` (joined under
        ``path_to_safe_data``; .txt / .tsv / .gz / .mat), or from a pandas
        DataFrame indexed by node key, both read and aligned to the node
        keys by ``io.read_attributes`` (other keyword arguments go on to it,
        e.g. ``mask_duplicates``); or from an (N, A) or (N,) float array in
        node order (NaN = unannotated). Then JAX's checks
        (``safe.py:416-419``): a ``ValidationError`` (a ``ValueError``) for
        +/-inf, a warning for all-NaN columns."""
        with _prof.span("facade.load_attributes"):
            self._load_attributes(kwargs)

    def _load_attributes(self, kwargs):
        if self._num_nodes is None:
            raise RuntimeError("load_network first")
        if "attribute_file" in kwargs:
            af = kwargs.pop("attribute_file")
            if self.path_to_safe_data is None or not isinstance(af, str):
                self.path_to_attribute_file = af
            else:
                self.path_to_attribute_file = os.path.join(
                    self.path_to_safe_data, af)
        source = self.path_to_attribute_file
        if isinstance(source, str) and not os.path.exists(source):
            raise AssertionError(source)
        self.validate_config()

        pd = sys.modules.get("pandas")
        if isinstance(source, str) or (pd is not None
                                       and isinstance(source, pd.DataFrame)):
            keys = None if self.graph is None else self.graph.node_attribute(
                self.node_key_attribute)
            if keys is None:
                raise ValueError("an attribute file or DataFrame needs node "
                                 "keys: load the network from a file or a "
                                 "networkx graph, or pass the attributes as "
                                 "an array in node order")
            if self.verbose and isinstance(source, str):
                logging.info("Loading attributes from %s" % source)
            attributes, _, values = _attr_io.read_attributes(
                attribute_file=source, node_label_order=list(keys),
                verbose=self.verbose, **kwargs)
        else:
            values = np.asarray(source, dtype=np.float64)
            if values.ndim == 1:
                values = values[:, None]
            attributes = {"id": np.arange(values.shape[1]),
                          "name": [f"attribute {j}"
                                   for j in range(values.shape[1])]}
        if values.ndim != 2 or values.shape[0] != self._num_nodes:
            raise ValueError(f"attributes must be ({self._num_nodes}, A), got "
                             f"{values.shape}")
        self.node2attribute = values
        self.attributes = attributes
        self._n2a_dev = None
        self._num_other_cache = None
        self._band_operands_cache = None
        self._attr_serial += 1
        validate_attributes(values, self._num_nodes, warn=self.verbose)

    def _node2attribute_device(self) -> torch.Tensor:
        """The f32 attribute matrix on the device, cached until the
        attributes change: one f64 transfer of the host matrix in row
        blocks, cast and counted on the device
        (``transfer.upload_f32_counted``), which caches the count of
        :meth:`_num_other_values` too. The span ``facade.attr_prep`` (route
        ``upload``)."""
        if self._n2a_dev is None:
            with _prof.span("facade.attr_prep", route="upload"):
                self._n2a_dev, self._num_other_cache = \
                    _transfer.upload_f32_counted(self.node2attribute,
                                                 device=self.device)
        return self._n2a_dev

    def _num_other_values(self) -> int:
        """Count of finite non-0/1 annotation values (``safe.py:1087``),
        counted on the f32 values the device gets, as the JAX facade counts
        on its f32 upload (``:1102-1105``): 1 + 1e-9 rounds to 1 and 1e39
        overflows to inf. Where the band GO prep is chunked
        (:meth:`_prep_chunked_selected`), counted on the device from
        column-chunked uploads (``:1096-1099``); else, without a mesh, by
        the f32 upload that the full-device prep keeps
        (:meth:`_node2attribute_device`); on a mesh, whose band GO path
        reads the host matrix, on the host. Cached until the attributes
        change; the chunked and host counts are the span
        ``facade.attr_prep`` (route ``chunked``, ``host``)."""
        if self._num_other_cache is None:
            if self._prep_chunked_selected():
                with _prof.span("facade.attr_prep", route="chunked"):
                    self._num_other_cache = _eb.count_other_values_chunked(
                        self.node2attribute, device=self.device)
            elif self.mesh is None:
                self._node2attribute_device()
            else:
                with _prof.span("facade.attr_prep", route="host"), \
                        np.errstate(over="ignore"):
                    v = np.asarray(self.node2attribute, np.float32)
                    self._num_other_cache = int(np.count_nonzero(
                        np.isfinite(v) & (v != 0) & (v != 1)))
        return self._num_other_cache

    def _binary(self) -> bool:
        """Does this enrichment take the hypergeometric test
        (``safe.py:1220-1221``)?"""
        return (self.enrichment_type == "hypergeometric"
                or (self.enrichment_type == "auto"
                    and self._num_other_values() == 0))

    # --------------------------------------------- lazy views of device results
    # A band-storage run holds BandedMatrix results: their dense views are
    # guarded (BandedMatrix.DENSE_MAX_BYTES); the *_sparse views are O(nnz).
    # The binary results are downloaded on first read (safe.py:602-664).

    @property
    def neighborhoods(self):
        if self._neighborhoods_np is None and self._neighborhoods_dev is not None:
            dev = self._neighborhoods_dev
            if isinstance(dev, BandedMatrix):
                self._neighborhoods_np = dev.to_dense().astype(int)
            else:
                self._neighborhoods_np = (dev.to(torch.int8).cpu().numpy()
                                          .astype(int))
        return self._neighborhoods_np

    @neighborhoods.setter
    def neighborhoods(self, value):
        """A caller-set indicator; the enrichment stages upload it."""
        self._neighborhoods_np = value
        self._neighborhoods_dev = None

    def neighborhoods_sparse(self):
        """scipy CSR of the neighborhood indicator (``safe.py:564``)."""
        dev = self._neighborhoods_dev
        if isinstance(dev, BandedMatrix):
            return dev.to_sparse()
        from scipy.sparse import csr_matrix
        return csr_matrix(np.asarray(self.neighborhoods))

    @property
    def node_distances(self):
        if (self._node_distances_np is None
                and self._node_distances_dev is not None):
            dev = self._node_distances_dev
            if isinstance(dev, BandedMatrix):
                self._node_distances_np = dev.to_dense().astype(np.float64)
            else:
                self._node_distances_np = dev.cpu().numpy().astype(np.float64)
        return self._node_distances_np

    @node_distances.setter
    def node_distances(self, value):
        self._node_distances_np = value
        self._node_distances_dev = None

    def node_distances_sparse(self):
        """scipy CSR of the within-radius distances (``safe.py:588``)."""
        dev = self._node_distances_dev
        if isinstance(dev, BandedMatrix):
            return dev.to_sparse()
        from scipy.sparse import csr_matrix
        d = np.asarray(self.node_distances)
        return csr_matrix(np.where(np.isfinite(d), d, 0.0))

    @property
    def nes(self):
        if self._nes_np is None:
            if (self._nes_dev is None and self._nes_from_logsf
                    and self._logsf_dev is not None
                    and not self._on_device(self._logsf_dev)):
                # a log-survival left on the host (a mesh run, the 'host'
                # residency): the host view, as for a pickle
                self._nes_np = _nes_from_logsf_host(self._logsf_dev.numpy())
            elif self._nes_device() is not None:
                with _prof.span("facade.results", name="nes"):
                    self._nes_np = _transfer.download_f64(self._nes_dev)
            elif self._nes_from_logsf and self._logsf_np is not None:
                # the pickled log-survival: the f64 divide and f32 round of
                # _nes_device(), on the host (safe.py:607-614)
                self._nes_np = _nes_from_logsf_host(self._logsf_np)
        return self._nes_np

    @nes.setter
    def nes(self, value):
        self._nes_np = value
        self._nes_dev = None
        self._nes_from_logsf = False

    def _nes_device(self):
        """The device NES, derived from the stored log-survival on first use
        where the run left none (after FDR): ``-logsf / ln 10`` in f64,
        rounded to f32 (``safe.py:1456``, ``_nes_from_logsf_jit`` :69)."""
        if (self._nes_dev is None and self._nes_from_logsf
                and self._logsf_dev is not None):
            self._nes_dev = (-self._logsf_dev.to(torch.float64)
                             / np.log(10.0)).to(torch.float32)
        return self._nes_dev

    def _nes_on_device(self):
        """The NES on ``device`` for a stage that computes on it. A
        log-survival left on the host (a mesh run, the 'host' residency)
        is uploaded 512 columns at a time and the NES derived on the
        device as :meth:`_nes_device` derives it; that NES is not kept."""
        chunk_cols = 512
        logsf = self._logsf_dev
        if (self._nes_dev is None and self._nes_from_logsf
                and logsf is not None and not self._on_device(logsf)):
            out = torch.empty(tuple(logsf.shape), dtype=torch.float32,
                              device=self.device)
            for j in range(0, logsf.shape[1], chunk_cols):
                x = logsf[:, j:j + chunk_cols].to(self.device)
                out[:, j:j + chunk_cols] = (-x.to(torch.float64)
                                            / np.log(10.0)).to(torch.float32)
            return out
        nes = self._nes_device()
        return None if nes is None else nes.to(self.device)

    def _nes_binary_on_device(self):
        """The int8 indicator on ``device`` for a stage that computes on
        it, uploaded (not kept) where a mesh run or the 'host' residency
        left it on the host."""
        b = self._nes_binary_dev
        return None if b is None else b.to(self.device)

    @property
    def pvalues_pos(self):
        if self._pvalues_pos_np is None:
            # f32 -> f64 is exact: the device and the pickled log-survival
            # give the same p-values (safe.py:622-639)
            log_sf = (self._logsf_np if self._logsf_np is not None
                      else None if self._logsf_dev is None
                      else self._logsf_dev.cpu().numpy())
            if log_sf is not None:
                with np.errstate(over="ignore"):
                    self._pvalues_pos_np = np.exp(log_sf.astype(np.float64))
        return self._pvalues_pos_np

    @pvalues_pos.setter
    def pvalues_pos(self, value):
        self._pvalues_pos_np = value
        self._logsf_dev = None
        self._logsf_np = None

    @property
    def nes_binary(self):
        if self._nes_binary_np is None:
            if self._nes_binary_pending is not None:
                self._update_binary_enrichment()
            src = (self._nes_binary_i8_np
                   if self._nes_binary_i8_np is not None
                   else self._nes_binary_dev)
            if src is not None:
                with _prof.span("facade.results", name="nes_binary"):
                    self._nes_binary_np = _transfer.download_f64(src)
        return self._nes_binary_np

    @nes_binary.setter
    def nes_binary(self, value):
        self._nes_binary_np = value
        self._nes_binary_dev = None
        self._nes_binary_i8_np = None
        self._nes_binary_csc = None
        self._domains_inter_cache = None
        self._enrichment_serial += 1

    def _neighborhoods_device(self) -> torch.Tensor:
        """(N, N) f32 device indicator, uploading a caller-set one
        (``safe.py:1108``)."""
        if isinstance(self._neighborhoods_dev, BandedMatrix):
            raise RuntimeError(
                "neighborhoods are band-stored (O(N*W)); the dense device "
                "matrix does not exist at this scale")
        if self._neighborhoods_dev is None:
            if self._neighborhoods_np is None:
                raise RuntimeError("define_neighborhoods has not been run")
            self._neighborhoods_dev = torch.as_tensor(
                np.asarray(self._neighborhoods_np, np.float32),
                device=self.device)
        return self._neighborhoods_dev

    def _on_device(self, t: torch.Tensor) -> bool:
        """Is ``t`` on the session's device? ``device="cuda"`` names the
        current card, where its tensors say ``cuda:0``."""
        d = self.device
        if t.device.type != d.type:
            return False
        if d.type != "cuda":
            return True
        return t.device.index == (torch.cuda.current_device()
                                  if d.index is None else d.index)

    def _band_device(self) -> BandedMatrix:
        """The indicator band on the session's device, uploaded once where
        a pickle, a checkpoint or a mesh run left it on the host: the
        stages compute on the device."""
        bm = self._neighborhoods_dev
        if (not isinstance(bm.data, torch.Tensor)
                or not self._on_device(bm.data)):
            bm.data = torch.as_tensor(bm.data, device=self.device)
        return bm

    def _release_device_results(self):
        """Drop the previous run's device matrices before computing new ones
        (``safe.py:1392``): a stale band or (N, A) result would otherwise
        share the device with the new run's until reassigned."""
        self._neighborhoods_dev = self._node_distances_dev = None
        self._neighborhoods_np = self._node_distances_np = None
        self._nes_dev = self._logsf_dev = self._nes_binary_dev = None
        self._logsf_np = None
        self._nes_from_logsf = False
        self._nes_binary_pending = None
        self._nes_binary_i8_np = self._nes_binary_csc = None
        self._domains_inter_cache = None

    # ------------------------------------------------------------ APSP plans

    def _banded_plan(self, coords, edges, lengths, num_nodes, nr):
        """((u, v, w) device edge arrays in banded order, inv_rank, window) or
        None (``safe.py:674``). The certificate needs edge lengths that ARE
        the Euclidean endpoint distances; the window must stay at most 3/4 of
        the padded matrix. Cached per radius."""
        if (self.apsp_mode != "auto"
                or self.node_distance_metric != "shortpath_weighted_layout"
                or lengths is None or len(edges) == 0):
            return None
        key = float(np.float32(nr))
        if key in self._banded_cache:
            return self._banded_cache[key]

        plan = None
        euclid = np.hypot(coords[edges[:, 0], 0] - coords[edges[:, 1], 0],
                          coords[edges[:, 0], 1] - coords[edges[:, 1], 1])
        if np.allclose(lengths, euclid, rtol=1e-7, atol=1e-12):
            order, band = _banded.banded_order(coords, nr * (1 + 1e-5))
            window = _banded.window_width(num_nodes, band)
            npad = -(-num_nodes // 128) * 128
            if window <= 0.75 * npad:  # below this the gather overhead wins
                rank = np.empty(num_nodes, dtype=np.int64)
                rank[order] = np.arange(num_nodes)
                permuted = rank[edges]
                dev = self.device
                init = (torch.as_tensor(permuted[:, 0], device=dev),
                        torch.as_tensor(permuted[:, 1], device=dev),
                        torch.as_tensor(np.asarray(lengths, np.float32),
                                        device=dev))
                plan = (init, torch.as_tensor(rank, device=dev), window)
        self._banded_cache[key] = plan
        return plan

    def _band_storage_plan(self, coords, edges, weights, num_nodes, nr):
        """Band-storage plan or None (``safe.py:762``).

        Taken with ``apsp_mode='band'``, or with ``'auto'`` at
        ``band_storage_min_nodes`` and above when the band is at most half
        the dense bytes. Two certificates, in order: the geometric one (edge
        lengths ARE the Euclidean endpoint distances, ``banded_order``) and
        the landmark one (any metric, ``graph_banded_order``). The certified
        band is bucketed (:meth:`_bucket_band`) before the half-of-dense
        rule, as in JAX. Returns dict(u, v, w (device edge arrays in banded
        order), rank, rank_dev, band (bucketed)). Cached per radius, mode
        and metric."""
        forced = self.apsp_mode == "band"
        if not forced and (self.apsp_mode != "auto"
                           or num_nodes < int(self.band_storage_min_nodes)):
            return None
        if (self.node_distance_metric not in ("shortpath_weighted_layout",
                                              "shortpath")
                or weights is None or len(edges) == 0):
            return None
        # forced flag in the key: a cached 'auto' rejection (None) must not
        # shadow a later apsp_mode='band' run
        key = (float(np.float32(nr)), forced, self.node_distance_metric)
        if key in self._bandstore_cache:
            return self._bandstore_cache[key]

        plan = None
        order = None
        if (self.node_distance_metric == "shortpath_weighted_layout"
                and coords is not None):
            euclid = np.hypot(coords[edges[:, 0], 0] - coords[edges[:, 1], 0],
                              coords[edges[:, 0], 1] - coords[edges[:, 1], 1])
            if np.allclose(weights, euclid, rtol=1e-7, atol=1e-12):
                order, band = _banded.banded_order(coords, nr * (1 + 1e-5))
        if order is None:
            order, band = _banded.graph_banded_order(num_nodes, edges,
                                                     weights, nr * (1 + 1e-5))
        band = self._bucket_band(band)
        # the band must beat dense storage (unless forced)
        if forced or (_bst.band_nbytes(num_nodes, band)
                      <= 0.5 * 4 * num_nodes * num_nodes):
            rank = np.empty(num_nodes, dtype=np.int64)
            rank[order] = np.arange(num_nodes)
            permuted = rank[edges]
            dev = self.device
            plan = dict(
                u=torch.as_tensor(permuted[:, 0], device=dev),
                v=torch.as_tensor(permuted[:, 1], device=dev),
                w=torch.as_tensor(np.asarray(weights, np.float32), device=dev),
                rank=rank, rank_dev=torch.as_tensor(rank, device=dev),
                band=int(band),
                # host edges for the sparse BF's slots, built on first use
                edges_perm=permuted,
                weights_np=np.asarray(weights, np.float32))
        self._bandstore_cache[key] = plan
        return plan

    def _euclidean_band_plan(self, coords, num_nodes, nr):
        """Band plan of the euclidean metric (``safe.py:734``): the band
        certificate is the measured index separation of the radius pairs
        themselves, with no edge contract. dict(rank, band) or None."""
        forced = self.apsp_mode == "band"
        if not forced and (self.apsp_mode != "auto"
                           or num_nodes < int(self.band_storage_min_nodes)):
            return None
        key = ("euclid", float(np.float32(nr)), forced)
        if key in self._bandstore_cache:
            return self._bandstore_cache[key]
        plan = None
        order, band = _banded.banded_order(coords, nr)
        band = self._bucket_band(band)
        if forced or (_bst.band_nbytes(num_nodes, band)
                      <= 0.5 * 4 * num_nodes * num_nodes):
            rank = np.empty(num_nodes, dtype=np.int64)
            rank[order] = np.arange(num_nodes)
            plan = dict(rank=rank, band=int(band))
        self._bandstore_cache[key] = plan
        return plan

    def _bucket_band(self, band: int, block: int = 128) -> int:
        """``band`` rounded up so that bt = band // block + 1 is a multiple
        of ``band_bt_bucket``: the largest band of that bt (``safe.py:897``).
        """
        bucket = int(self.band_bt_bucket or 0)
        if bucket <= 1:
            return int(band)
        bt = _bst.band_params(0, band, block)[0]  # bt does not read n
        bt = -(-bt // bucket) * bucket
        return bt * block - 1

    def _band_bits_selected(self, num_nodes, band):
        """Bit-pack the indicator band (``safe.py:990``)?"""
        if self.band_indicator_bits == "auto":
            return (_bst.band_nbytes(num_nodes, band, itemsize=1)
                    >= float(self.band_bits_min_bytes))
        return bool(self.band_indicator_bits)

    def _data_mesh(self) -> bool:
        """Is ``mesh`` a DeviceMesh of exactly one axis, named "data" (the
        only mesh band storage takes, ``safe.py:1711-1714``)?"""
        return mesh_names(self.mesh) == ("data",)

    def _sharded_fw(self) -> bool:
        """Does the mesh shard the dense FW (a ``data`` axis, or ``row`` and
        ``col``)? Then no banded window is taken (``safe.py:490-491``)."""
        return fw_sharding(self.mesh) is not None

    def _mesh_seed(self) -> int:
        """The null's seed: ``random_seed``, else a fresh one, which on a
        mesh its first rank draws and shares (``mesh.shared_seed``)."""
        seed = self.random_seed
        if seed is None:
            seed = int(np.random.default_rng().integers(2 ** 31 - 1))
            if self.mesh is not None:
                from safepy_tpu_torch.parallel.mesh import shared_seed
                seed = shared_seed(seed, self.mesh, None, self.device)
        return int(seed)

    def _band_bf_args(self, plan):
        """(bf_slots, bf_max_iters) keyword arguments of the band pipelines
        for ``band_relax`` (``safe.py:827``): {} = the FW. The slots are
        built on the first 'bf' run and kept in the plan; a band too wide
        for them (``band_bf_slots`` returns None) takes the FW."""
        if self.band_relax != "bf":
            return {}
        if "bf_slots" not in plan:
            n = int(len(plan["rank"]))
            slots = _bst.band_bf_slots(
                plan["edges_perm"][:, 0], plan["edges_perm"][:, 1],
                plan["weights_np"], n=n, band=int(plan["band"]))
            if slots is None:
                plan["bf_slots"] = None
            else:
                nbr, dlt, wgt, s_slots = slots
                dev = self.device
                plan["bf_slots"] = tuple(torch.as_tensor(x, device=dev)
                                         for x in (nbr, dlt, wgt))
                plan["bf_max_iters"] = _bst.bf_max_iters(
                    n, int(plan["band"]), s_slots)
        if plan["bf_slots"] is None:
            return {}
        return dict(bf_slots=plan["bf_slots"],
                    bf_max_iters=int(plan["bf_max_iters"]))

    def _band_front_dispatch(self, plan, radius, num_nodes):
        """``pipeline.band_neighborhoods`` with the selected relax
        (``safe.py:856``): when the sparse BF runs out of rounds (the band
        then holds upper bounds) the FW runs again from the start. Records
        the relax that gave the result in ``_band_relax_used``. Returns
        (dist_band or None, s_ind, mean, std)."""
        kw = dict(n=num_nodes, band=plan["band"],
                  keep_distances=bool(self.keep_node_distances),
                  packed=self._band_bits_selected(num_nodes, plan["band"]))
        edges = (plan["u"], plan["v"], plan["w"], radius)
        bf = self._band_bf_args(plan)
        if bf:
            out = _pipe.band_neighborhoods(*edges, **kw, **bf)
            if out[4]:
                self._band_relax_used = "bf"
                return out[:4]
            del out
            self._band_relax_used = "bf->fw"
            logging.info("band BF relax hit its iteration budget; "
                         "re-dispatching Floyd-Warshall")
        else:
            self._band_relax_used = "fw"
        return _pipe.band_neighborhoods(*edges, **kw)[:4]

    def _euclidean_band_front(self, coords, plan, nr):
        """``pipeline.euclidean_band_neighborhoods`` of the coordinates,
        uploaded in the banded order of ``plan``: (dist_band or None, s_ind,
        mean, std). Without kept distances the indicator is built directly,
        bit-packed when ``_band_bits_selected``."""
        n, band = self._num_nodes, plan["band"]
        keep = bool(self.keep_node_distances)
        return _pipe.euclidean_band_neighborhoods(
            torch.as_tensor(coords[np.argsort(plan["rank"])],
                            dtype=torch.float32, device=self.device),
            np.float32(nr), n=n, band=band, keep_distances=keep,
            packed=not keep and self._band_bits_selected(n, band))

    def _radius(self, coords, lengths, edge_weights):
        """(radius, edge weights) of the node distance metric: a fraction of
        the layout's x-extent for 'shortpath_weighted_layout' (over edge
        lengths) and 'euclidean', absolute for 'shortpath' (over edge
        weights)."""
        if self.node_distance_metric == "shortpath":
            return self.neighborhood_radius, edge_weights
        x = coords[:, 0]
        nr = self.neighborhood_radius * (np.max(x) - np.min(x))
        if self.node_distance_metric == "euclidean":
            return nr, None
        if lengths is None:
            raise ValueError(
                "shortpath_weighted_layout requires edge 'length' "
                "attributes (or lengths in the network arrays)")
        return nr, lengths

    # ---------------------------------------------------------- neighborhoods

    def define_neighborhoods(self, **kwargs):
        """The neighborhood indicator and distances, left on the device
        (``safe.py:423``): band storage, the banded window or the dense FW
        for the shortest-path metrics, the dense distance matrix for the
        euclidean one."""
        for k in ("node_distance_metric", "neighborhood_radius_type",
                  "neighborhood_radius"):
            if k in kwargs:
                setattr(self, k, kwargs[k])
        self._validate()
        if self._num_nodes is None:
            raise RuntimeError("load_network first")

        num_nodes = self._num_nodes
        coords, edges, lengths, edge_weights = self._arrays()
        nr, weights = self._radius(coords, lengths, edge_weights)
        if self.node_distance_metric == "euclidean":
            eb_plan = self._euclidean_band_plan(coords, num_nodes, nr)
            if eb_plan is not None:
                # drop the previous bands before building new ones
                self._neighborhoods_dev = self._node_distances_dev = None
                return self._store_band_neighborhoods(
                    eb_plan, self._euclidean_band_front(coords, eb_plan, nr))
            dist = _nbr.euclidean_distance_matrix(torch.as_tensor(
                coords, dtype=torch.float32, device=self.device))
            nbr, mean, std = _nbr.threshold_and_stats(dist, np.float32(nr),
                                                      strict=True)
            self.apsp_engine_used, self.window_used = "euclidean", None
            return self._store_neighborhoods(nbr, dist, mean, std)

        radius = _nbr.inclusive_radius(nr)
        # no band storage on a mesh (safe.py:491-492)
        bs_plan = (None if self.mesh is not None else self._band_storage_plan(
            coords, edges, weights, num_nodes, nr))
        if bs_plan is not None:
            # drop the previous bands before building new ones
            self._neighborhoods_dev = self._node_distances_dev = None
            return self._store_band_neighborhoods(
                bs_plan, self._band_front_dispatch(bs_plan, radius, num_nodes))
        d0, inv_rank, window = self._dense_front(coords, edges, weights,
                                                 num_nodes, nr)
        dist = _pipe._apsp_inline(d0, 128, mesh=self.mesh, window=window,
                                  inv_rank=inv_rank, radius=radius)
        nbr, mean, std = _nbr.threshold_and_stats(dist, radius, strict=False)
        self._store_neighborhoods(nbr, dist, mean, std)

    def _dense_front(self, coords, edges, weights, num_nodes, nr):
        """(d0, inv_rank, window) of the banded window when its plan holds
        and the mesh shards no FW, else the cached dense FW initialization
        (inv_rank, window None), and the engine recorded: on a mesh that
        shards the FW, ``dense-sharded`` (a ``data`` axis) or
        ``dense-sharded-2d`` (``row`` and ``col``)."""
        plan = (None if self._sharded_fw() else self._banded_plan(
            coords, edges, weights, num_nodes, nr))
        if plan is not None:
            d0, inv_rank, window = plan
            self.apsp_engine_used, self.window_used = "banded-window", window
            return d0, inv_rank, window
        d0 = self._d0_cache.get(self.node_distance_metric)
        if d0 is None:
            d0 = _nbr.initial_distances_device(num_nodes, edges, weights,
                                               device=self.device)
            self._d0_cache[self.node_distance_metric] = d0
        self.apsp_engine_used = {"2d": "dense-sharded-2d",
                                 "data": "dense-sharded",
                                 None: "dense"}[fw_sharding(self.mesh)]
        self.window_used = None
        return d0, None, None

    def _store_band_neighborhoods(self, plan, front):
        """:meth:`_store_neighborhoods` of a band front's (dist_band or None,
        s_ind, mean, std), the bands wrapped with the frame of ``plan``, and
        the engine recorded."""
        dist_band, s_ind, mean, std = front
        rank, band, n = plan["rank"], plan["band"], self._num_nodes
        self.apsp_engine_used, self.window_used = "band-storage", None
        self._store_neighborhoods(
            BandedMatrix(s_ind, rank, n, band, fill=0.0),
            None if dist_band is None
            else BandedMatrix(dist_band, rank, n, band, fill=np.inf),
            mean, std)

    def _store_neighborhoods(self, nbr, dist, mean, std):
        """The indicator and distances stay where the run left them (dense
        tensors or bands); the views download them on first read."""
        self._neighborhoods_dev = nbr
        self._neighborhoods_np = None
        self._node_distances_dev = dist
        self._node_distances_np = None
        if self.verbose:
            logging.info("Node distance metric: %s (%s)"
                         % (self.node_distance_metric, self.apsp_engine_used))
            logging.info("Neighborhood definition: %.2f x %s"
                         % (self.neighborhood_radius,
                            self.neighborhood_radius_type))
            logging.info("Number of nodes per neighborhood (mean +/- std): "
                         "%.2f +/- %.2f" % (float(mean), float(std)))

    # -------------------------------------------------------------- p-values

    def compute_pvalues(self, *, perm_idx=None, **kwargs):
        """Enrichment of the defined neighborhoods (``safe.py:1183``): the
        hypergeometric test for binary attributes ('auto'), else the
        permutation null, which takes explicit permutations ``perm_idx``
        (P, V) as ``run_pipeline`` does. The keyword arguments go on to the
        test, which logs them and reads those it knows.

        ``background='network'`` sets the unannotated values to 0 (on a new
        array) before the test."""
        if "how" in kwargs:
            self.enrichment_type = kwargs["how"]
        for k in ("neighborhood_score_type", "multiple_testing",
                  "background"):
            if k in kwargs:
                setattr(self, k, kwargs[k])
        self._validate()
        if self.node2attribute is None:
            raise RuntimeError("load_attributes first")
        binary = self._binary()  # NaN -> 0 below does not change it

        if self.background == "network":
            logging.info("Setting all null attribute values to 0. Using the "
                         "network as background for enrichment.")
            n2a = self.node2attribute
            self.node2attribute = np.where(np.isnan(n2a), 0.0, n2a)
            self._n2a_dev = None
            self._num_other_cache = None
            self._band_operands_cache = None
            self._attr_serial += 1

        num_nans = np.sum(np.isnan(self.node2attribute), axis=0)
        if np.any(num_nans / self.node2attribute.shape[0] > 0.5):
            logging.warning(
                "WARNING: more than 50%% of nodes in the network are set to "
                "NaN and will be ignored for calculating enrichment.\n"
                "Consider setting sf.background = 'network'.")

        if binary:
            self.compute_pvalues_by_hypergeom(**kwargs)
        else:
            self.compute_pvalues_by_randomization(perm_idx=perm_idx, **kwargs)
        self._update_binary_enrichment()

    def _log_kwargs(self, kwargs, header):
        if "verbose" in kwargs:
            self.verbose = kwargs["verbose"]
        if kwargs and self.verbose:
            logging.warning(header)
            for k in kwargs:
                logging.warning("\t%s=%s" % (k, str(kwargs[k])))

    def compute_pvalues_by_hypergeom(self, **kwargs):
        """One-sided hypergeometric enrichment (``safe.py:1228``).

        Over dense neighborhoods: the census GEMMs on the device, the tail
        sum on the device and its finalization on the host, in f64; unlike
        the fused path, the tail's length is bounded by the largest
        neighborhood, and FDR adjusts the linear p-values (``fdr_bh``), as
        in JAX. Over band storage: :meth:`_band_hypergeom` of the stored
        band, with ``-staged`` engine names."""
        self._log_kwargs(kwargs, "Overwriting global settings:")
        self._validate()
        if self.verbose:
            logging.info("Using the hypergeometric test to calculate "
                         "enrichment...")
        n2a = self.node2attribute
        if isinstance(self._neighborhoods_dev, BandedMatrix):
            bm = self._band_device()
            _, out = self._band_hypergeom(lambda: (None, bm.data, None, None),
                                          bm.n, bm.band, bm.rank, staged=True)
            return self._store_hypergeom_results(None, *out)
        if "attr" in mesh_names(self.mesh):
            # the columns sharded over the 'attr' axis, census and f64 tail
            # on each rank (safe.py:1252-1266)
            from safepy_tpu_torch.parallel.hypergeom_sharded import (
                hypergeom_enrichment_sharded)
            out = hypergeom_enrichment_sharded(
                self._neighborhoods_device(), n2a, mesh=self.mesh,
                enrichment_threshold=self.enrichment_threshold,
                node2attribute_device=self._node2attribute_device())
            self._hypergeom_engine_used = "loop-dense-attr-sharded"
            return self._store_hypergeom_results(*out)
        nodes_not_nan = np.any(~np.isnan(n2a), axis=1)
        n = int(np.sum(nodes_not_nan))
        N_in_group = np.nansum(n2a, axis=0, dtype=np.float64)  # totals (A,)

        check_fp32_matmul(self.matmul_precision)
        nbr = self._neighborhoods_device()
        neighborhood_size = (nbr @ torch.as_tensor(
            nodes_not_nan, dtype=torch.float32, device=self.device)
        ).cpu().numpy()
        n2a_dev = self._node2attribute_device()
        counts = nbr @ torch.where(torch.isfinite(n2a_dev), n2a_dev,
                                   torch.zeros_like(n2a_dev))

        k_max = int(max(1, np.nanmax(N_in_group))) if N_in_group.size else 1
        iters = _hyper.tail_iterations(
            n, int(min(k_max, max(1, neighborhood_size.max(initial=1)))))
        self._hypergeom_engine_used = "loop-dense-staged"
        self.pvalues_pos, nes = _hyper.hypergeom_sf_and_nes(
            counts, n, N_in_group[None, :], neighborhood_size[:, None],
            iterations=iters)
        if self.multiple_testing:
            if self.verbose:
                logging.info("Running FDR-adjustment of p-values...")
            self.pvalues_pos = self._fdr_bh(self.pvalues_pos)
            with np.errstate(divide="ignore"):
                self.nes = -np.log10(self.pvalues_pos)
        else:
            self.nes = nes

    def _fdr_bh(self, p):
        """``fdr_bh`` of a host matrix, computed on the session's device."""
        return _fdr.fdr_bh(torch.as_tensor(p, device=self.device)).cpu().numpy()

    def _dense_table_kwargs(self, K_np, M, num_other,
                            budget_cells=3 * 10 ** 8):
        """Arguments routing the dense fused pipeline onto the class table
        (``safe.py:1303``), or {} for the f64 tail loop: binary annotations
        and a table within budget whose rows cover every neighborhood size
        (n <= M)."""
        if self.hypergeom_engine not in ("auto", "table") or num_other != 0:
            return {}
        k_dist, colc = np.unique(np.asarray(K_np, np.float64),
                                 return_inverse=True)
        r, s_max = _htab.table_geometry(k_dist, M, M)
        c = 1
        while c < max(1, len(k_dist)):
            c *= 2
        if s_max * c * r > budget_cells:
            return {}
        k_pad = np.zeros(c, np.float64)
        k_pad[:len(k_dist)] = k_dist
        return dict(table_K_dist=torch.as_tensor(k_pad, device=self.device),
                    table_colc=torch.as_tensor(colc.reshape(-1),
                                               device=self.device),
                    table_spec=(r, s_max, c))

    def _store_hypergeom_results(self, nes32, log_sf32, nes_binary8, counts):
        """The fused binary results, left on the device (``safe.py:1408``).
        With ``multiple_testing`` the log-survival is BH-adjusted on the
        device in log space (``fdr_bh_logsf``) and replaces the stored one;
        the NES then derives from it on first read. The host residency's
        numpy matrices (``logsf_store='host'``) are adjusted on the host
        (``fdr_bh_logsf_np``, ``safe.py:1426-1428``) and kept as host
        tensors, from which every view serves."""
        host_mode = isinstance(log_sf32, np.ndarray)
        if self.multiple_testing:
            if self.verbose:
                logging.info("Running FDR-adjustment of p-values...")
            if host_mode:
                log_sf32, nes_binary8, counts = _fdr.fdr_bh_logsf_np(
                    log_sf32, np.log(self.enrichment_threshold))
            else:
                log_sf32, nes_binary8, counts = _fdr.fdr_bh_logsf(
                    log_sf32, np.log(self.enrichment_threshold),
                    row_chunk=self._fdr_row_chunk(tuple(log_sf32.shape)))
            nes32 = None
        if host_mode:
            log_sf32 = torch.from_numpy(log_sf32)
            nes_binary8 = torch.from_numpy(nes_binary8)
            counts = torch.as_tensor(counts)
        self._pvalues_pos_np = None
        self._nes_np = None
        self._logsf_np = None
        self._logsf_dev = log_sf32
        self._nes_dev = nes32
        self._nes_from_logsf = nes32 is None
        self._nes_binary_pending = (nes_binary8, counts)

    @staticmethod
    def _fdr_row_chunk(shape, budget_bytes=2 * 10 ** 9):
        """Row chunk keeping one BH pass's f64 sort temporaries (~4 copies
        of the chunk) under ``budget_bytes`` (``safe.py:1448``); None =
        unchunked."""
        n, a = shape
        if n * a * 8 * 4 <= budget_bytes:
            return None
        return max(128, int(budget_bytes // (a * 8 * 4)) // 128 * 128)

    def compute_pvalues_by_randomization(self, *, perm_idx=None, **kwargs):
        """Two-sided permutation null over the defined neighborhoods
        (``safe.py:1573``), dense or band-stored. ``perm_idx`` (P, V):
        explicit permutations of the V annotated rows (original order)
        instead of the session's generator. On a mesh with a ``perm`` axis
        the permutations split over every axis of the mesh
        (``parallel.permutation_sharded``, ``safe.py:1616-1624``) and
        ``num_permutations`` is rounded up to a multiple of the device
        count."""
        self._log_kwargs(kwargs, "Current settings (possibly overwriting "
                                 "global ones):")
        if self.verbose:
            logging.info("Using randomization to calculate enrichment...")
        if "num_permutations" in kwargs:
            self.num_permutations = kwargs["num_permutations"]
        if "processes" in kwargs and int(kwargs["processes"]) > 1:
            logging.info("processes=%s requested: the engine batches "
                         "permutations on the device; ignoring."
                         % kwargs["processes"])
        if perm_idx is not None:
            self.num_permutations = len(perm_idx)
        self._validate()

        if isinstance(self._neighborhoods_dev, BandedMatrix):
            return self._randomization_bandstore(self._band_device(),
                                                 perm_idx)
        n2a = self.node2attribute
        n2a_dev = self._node2attribute_device()
        nbr_dev = self._neighborhoods_device()
        obs_dev = compute_neighborhood_score(
            nbr_dev, n2a_dev, self.neighborhood_score_type,
            self.matmul_precision)
        valid_rows = np.flatnonzero(np.sum(~np.isnan(n2a), axis=1))
        valid_dev = (None if len(valid_rows) == n2a.shape[0]
                     else torch.as_tensor(valid_rows, device=self.device))
        if "perm" in mesh_names(self.mesh):
            from safepy_tpu_torch.parallel.permutation_sharded import (
                run_permutations_sharded)
            counts_neg, counts_pos, total = run_permutations_sharded(
                nbr_dev, n2a_dev, valid_dev, obs_dev,
                None if perm_idx is not None else self._mesh_seed(),
                mesh=self.mesh, score_type=self.neighborhood_score_type,
                num_permutations=int(self.num_permutations),
                precision=self.matmul_precision, perm_idx=perm_idx)
            # rounded up to a multiple of the device count, as the
            # reference rounds to its worker count (safe.py:503-504)
            self.num_permutations = total
        else:
            counts_neg, counts_pos = _perm.run_permutations(
                nbr_dev, n2a_dev, valid_dev, obs_dev,
                generator=self._generator(perm_idx), perm_idx=perm_idx,
                score_type=self.neighborhood_score_type,
                num_permutations=int(self.num_permutations),
                precision=self.matmul_precision)
        self._store_null(obs_dev, counts_neg, counts_pos)

    def _randomization_bandstore(self, bm, perm_idx):
        """The permutation null over band-stored neighborhoods
        (``safe.py:1467``): banded scores, valid-column compaction, banded
        count scan, rows un-permuted on the device."""
        tail_args, kw = self._band_null_operands(bm.rank, bm.bt, perm_idx)
        obs, counts_neg, counts_pos = _pipe._band_perm_tail(
            bm.data, *tail_args, bt=bm.bt, block=bm.block, **kw)
        self._store_null(obs, counts_neg, counts_pos)

    def _store_null(self, obs, counts_neg, counts_pos):
        """Scores and null counts to the host, then p-values and NES."""
        with _prof.span("facade.wait", site="store_null.obs"):
            self.ns = obs.cpu().numpy()
        with _prof.span("facade.wait", site="store_null.counts_neg"):
            self.counts_neg = counts_neg.cpu().numpy()
        with _prof.span("facade.wait", site="store_null.counts_pos"):
            self.counts_pos = counts_pos.cpu().numpy()
        self._finalize_randomization(self.counts_neg, self.counts_pos,
                                     self.ns)

    def _finalize_randomization(self, counts_neg, counts_pos, obs):
        """counts -> p-values -> NES on the host in f64 (``safe.py:1511``):
        NaN where obs is NaN, FDR when asked (on the device), p = 0 floored
        to 1/P, sign select."""
        counts_neg = np.asarray(counts_neg, dtype=np.float64)
        counts_pos = np.asarray(counts_pos, dtype=np.float64)
        idx = np.isnan(obs)
        counts_neg[idx] = np.nan
        counts_pos[idx] = np.nan

        self.pvalues_neg = counts_neg / self.num_permutations
        self.pvalues_pos = counts_pos / self.num_permutations

        if self.multiple_testing:
            if self.verbose:
                logging.info("Running FDR-adjustment of p-values...")
            self.pvalues_neg = self._fdr_bh(self.pvalues_neg)
            self.pvalues_pos = self._fdr_bh(self.pvalues_pos)

        nes_pos = -np.log10(np.where(self.pvalues_pos == 0,
                                     1 / self.num_permutations,
                                     self.pvalues_pos))
        nes_neg = -np.log10(np.where(self.pvalues_neg == 0,
                                     1 / self.num_permutations,
                                     self.pvalues_neg))
        if self.attribute_sign == "highest":
            self.nes = nes_pos
        elif self.attribute_sign == "lowest":
            self.nes = nes_neg
        else:
            self.nes = nes_pos - nes_neg

    def _update_binary_enrichment(self):
        """nes_binary and per-attribute enriched counts (``safe.py:1541``):
        a device run hands over its int8 indicator (downloaded on first read)
        and its counts, reduced on the device; otherwise both come from
        ``nes`` on the host."""
        if self._nes_binary_pending is not None:
            self._nes_binary_dev, counts = self._nes_binary_pending
            self._nes_binary_pending = None
            # a new indicator: the views and intersections of the last one
            # go (the JAX facade drops them at the start of each run)
            self._nes_binary_np = self._nes_binary_i8_np = None
            self._nes_binary_csc = self._domains_inter_cache = None
            self._enrichment_serial += 1
            counts = counts.cpu().numpy()
        else:
            idx = ~np.isnan(self.nes)
            nes_binary = np.zeros(self.nes.shape)
            nes_binary[idx] = (np.abs(self.nes[idx])
                               > -np.log10(self.enrichment_threshold))
            self.nes_binary = nes_binary
            counts = np.sum(nes_binary, axis=0)
        self.attributes["num_neighborhoods_enriched"] = counts

    # -------------------------------------------------------------- pipeline

    def run_pipeline(self, *, perm_idx=None, **kwargs):
        """Neighborhoods + enrichment (``safe.py:1635``), the equivalent of
        ``define_neighborhoods(); compute_pvalues()``: fused for the
        shortest-path metrics and for a quantitative run over the euclidean
        band, the stages for the rest of the euclidean metric and for
        ``background='network'``.

        ``perm_idx`` (P, V): explicit permutations of the V annotated rows
        for the permutation null (``num_permutations`` becomes P). Other
        keyword arguments set the settings of those names; the rest are
        ignored, as in JAX (``safe.py:1646-1660``).
        """
        with _prof.span("facade.run_pipeline") as sp:
            self._run_pipeline(perm_idx, kwargs)
            if sp is not None:
                sp.attrs["engine"] = self.apsp_engine_used

    def _run_pipeline(self, perm_idx, kwargs):
        for k in ("node_distance_metric", "neighborhood_radius_type",
                  "neighborhood_radius", "neighborhood_score_type",
                  "multiple_testing", "num_permutations", "background"):
            if k in kwargs:
                setattr(self, k, kwargs[k])
        if "how" in kwargs:
            self.enrichment_type = kwargs["how"]
        if perm_idx is not None:
            self.num_permutations = len(perm_idx)
        self._validate()
        if self.node2attribute is None:
            raise RuntimeError("load_attributes first")

        num_nodes = self._num_nodes
        coords, edges, lengths, edge_weights = self._arrays()
        binary = self._binary()
        euclid = self.node_distance_metric == "euclidean"
        staged = euclid or self.background == "network"
        nr, weights = self._radius(coords, lengths, edge_weights)
        bs_plan = None
        if euclid:
            # fused over the euclidean band without a mesh or on one 'data'
            # axis (safe.py:1663-1680), the stages otherwise
            eb_plan = (None if binary or self.background == "network"
                       or not (self.mesh is None or self._data_mesh())
                       else self._euclidean_band_plan(coords, num_nodes, nr))
            if eb_plan is not None:
                return self._run_pipeline_band_null(eb_plan, nr, perm_idx,
                                                    coords=coords)
        elif self.mesh is None or self._data_mesh():
            # band storage takes no mesh but one 'data' axis (safe.py:1712)
            bs_plan = self._band_storage_plan(coords, edges, weights,
                                              num_nodes, nr)
        if staged:
            self.define_neighborhoods()
            self.compute_pvalues(perm_idx=perm_idx)
            return
        if bs_plan is not None and binary:
            if self.mesh is not None:
                return self._run_pipeline_band_hypergeom_sharded(bs_plan, nr)
            self._release_device_results()
            radius = _nbr.inclusive_radius(nr)
            front, out = self._band_hypergeom(
                lambda: self._band_front_dispatch(bs_plan, radius, num_nodes),
                num_nodes, bs_plan["band"], bs_plan["rank"])
            return self._end_band_run(bs_plan, front,
                                      self._store_hypergeom_results, None,
                                      *out)
        if bs_plan is not None:
            return self._run_pipeline_band_null(bs_plan, nr, perm_idx)
        d0, inv_rank, window = self._dense_front(coords, edges, weights,
                                                 num_nodes, nr)
        radius = _nbr.inclusive_radius(nr)
        if binary:
            dist, nbr, mean, std = self._fused_hypergeom(d0, inv_rank, window,
                                                         radius)
            self._store_neighborhoods(nbr, dist, mean, std)
            self._update_binary_enrichment()
            return

        n2a = self.node2attribute
        valid_rows = np.flatnonzero(np.sum(~np.isnan(n2a), axis=1))
        V, A = len(valid_rows), n2a.shape[1]
        valid_dev = (None if V == n2a.shape[0]  # every row valid: no gather
                     else torch.as_tensor(valid_rows, device=self.device))
        per_device = int(self.num_permutations)
        if self.mesh is None:
            generator = self._generator(perm_idx)
        else:
            # the batch splits over every mesh axis, rounded up to a
            # multiple of the device count (safe.py:1759-1766); each rank
            # draws its own permutations
            from safepy_tpu_torch.parallel import permutation_sharded as ps
            ndev, _ = ps.split_index(self.mesh)
            per_device = -(-per_device // ndev)
            self.num_permutations = per_device * ndev
            generator = (None if perm_idx is not None else ps.rank_generator(
                self._mesh_seed(), self.mesh, self.device))
        batch = _perm.default_batch_size(V, A, per_device)
        (dist, nbr, obs, counts_neg, counts_pos, mean, std) = \
            _pipe.fused_permutation_pipeline(
                d0, self._node2attribute_device(), valid_dev, generator,
                radius, score_type=self.neighborhood_score_type,
                num_permutations=per_device,
                batch_size=batch, precision=self.matmul_precision,
                mesh=self.mesh, window=window, inv_rank=inv_rank,
                perm_idx=perm_idx)
        self._store_results(obs, counts_neg, counts_pos, nbr, dist, mean, std)

    def _fused_hypergeom(self, d0, inv_rank, window, radius):
        """The binary branch of ``run_pipeline`` (``safe.py:1723-1749``):
        the census and survival over the whole population M, by the class
        table or the f64 tail loop; results stay on the device. Returns
        (dist, nbr, mean, std)."""
        n2a = self.node2attribute
        M = int(np.any(~np.isnan(n2a), axis=1).sum())
        K_np = np.nansum(n2a, axis=0, dtype=np.float64)
        k_max = int(max(1, np.nanmax(K_np))) if K_np.size else 1
        iters = _hyper.tail_iterations(M, min(k_max, M))
        lgt = torch.as_tensor(_hyper.lgamma_table(M), device=self.device)
        table_kw = self._dense_table_kwargs(K_np, M, self._num_other_values())
        self._hypergeom_engine_used = ("table-dense-fused" if table_kw
                                       else "loop-dense-fused")
        (dist, nbr, nes32, log_sf32, nesbin8, counts_dev, mean, std) = \
            _pipe.fused_hypergeom_pipeline(
                d0, self._node2attribute_device(), lgt, M, radius,
                np.float64(self.enrichment_threshold), iterations=iters,
                mesh=self.mesh, window=window, inv_rank=inv_rank,
                **table_kw)
        self._store_hypergeom_results(nes32, log_sf32, nesbin8, counts_dev)
        return dist, nbr, mean, std

    def _generator(self, perm_idx):
        """The null's torch.Generator from ``random_seed`` (a fresh seed
        when None), or None when explicit permutations are given. On a mesh
        a fresh seed is drawn by the mesh's first rank and shared, so that
        every rank draws the same permutations (the row-sharded band
        engine's null)."""
        if perm_idx is not None:
            return None
        return torch.Generator(device=self.device).manual_seed(
            self._mesh_seed())

    def _store_results(self, obs, counts_neg, counts_pos, nbr, dist, mean,
                       std):
        """A fused quantitative run's results: scores, counts and p-values
        to the host; the neighborhoods and distances stay where the run left
        them (dense tensors or bands)."""
        self._store_null(obs, counts_neg, counts_pos)
        self._store_neighborhoods(nbr, dist, mean, std)
        self._update_binary_enrichment()

    def _run_pipeline_band_null(self, plan, nr, perm_idx, coords=None):
        """run_pipeline's quantitative branch over band storage
        (``safe.py:2048-2145``; with ``coords``, the euclidean metric's,
        ``safe.py:1795``): the null's operands, then the band front (over
        the edges, :meth:`_band_front_dispatch`, or straight from the
        coordinates with no graph algorithm, :meth:`_euclidean_band_front`),
        then the tail that :meth:`_randomization_bandstore` runs on a stored
        band. Every matrix is O(N W); the neighborhoods and distances become
        :class:`BandedMatrix` results. On a "data" mesh the row-sharded
        engines run (``safe.py:2073-2082``, ``:1831-1843``)."""
        n, band, rank = self._num_nodes, plan["band"], plan["rank"]
        self._release_device_results()
        bt = _bst.band_params(n, band)[0]
        tail_args, kw = self._band_null_operands(rank, bt, perm_idx)
        if self.mesh is None:
            front = (self._band_front_dispatch(
                plan, _nbr.inclusive_radius(nr), n) if coords is None
                else self._euclidean_band_front(coords, plan, nr))
            obs, counts_neg, counts_pos = _pipe._band_perm_tail(
                front[1], *tail_args, bt=bt, block=128, **kw)
        else:
            from safepy_tpu_torch.parallel import band_sharded as _bsh
            keep = bool(self.keep_node_distances)
            packed = self._band_bits_selected(n, band)
            kw.update(mesh=self.mesh, n=n, band=band, keep_distances=keep)
            if coords is None:
                self._band_relax_used = "fw"  # the sharded engine's relax
                out = _bsh.fused_permutation_pipeline_band_sharded(
                    plan["u"], plan["v"], plan["w"], *tail_args,
                    _nbr.inclusive_radius(nr), packed=packed, **kw)
            else:
                out = _bsh.fused_permutation_pipeline_band_euclid_sharded(
                    torch.as_tensor(coords[np.argsort(rank)],
                                    dtype=torch.float32, device=self.device),
                    *tail_args, np.float32(nr), packed=not keep and packed,
                    **kw)
            dist_band, s_ind, obs, counts_neg, counts_pos, mean, std = out
            front = (dist_band, s_ind, mean, std)
        self._end_band_run(plan, front, self._store_null, obs, counts_neg,
                           counts_pos)

    def _end_band_run(self, plan, front, store, *results):
        """What every band ``run_pipeline`` does after its engine: on a mesh
        the bands of ``front`` (dist_band or None, s_ind, mean, std),
        assembled in host memory, lose the rows that pad the ghosted
        block-rows to a multiple of the rank count (``safe.py:2122-2127``);
        then ``store(*results)`` stores the enrichment, the bands are
        stored in their frame and the binary enrichment is updated."""
        dist_band, s_ind, mean, std = front
        if self.mesh is not None:
            bt, nb, _ = _bst.band_params(self._num_nodes, plan["band"])
            g_rows = (nb + 2 * bt) * 128
            s_ind = s_ind[:g_rows]
            dist_band = None if dist_band is None else dist_band[:g_rows]
        store(*results)
        self._store_band_neighborhoods(plan, (dist_band, s_ind, mean, std))
        self._update_binary_enrichment()

    def _band_null_operands(self, rank, bt, perm_idx):
        """The permutation null's operands over a band in the permuted frame
        (``safe.py:2053-2068``): ((vals, vals_valid, valid, starts, rank,
        generator) on the device, the tail's keyword arguments)."""
        order = np.argsort(rank)  # permuted position -> original node
        n2a = self.node2attribute
        vals_perm = np.asarray(n2a, np.float32)[order]
        valid_perm = np.any(~np.isnan(vals_perm), axis=1)
        V, A = int(valid_perm.sum()), n2a.shape[1]
        starts, w_c = _bst.compaction_plan(valid_perm, n=len(rank), bt=bt)
        dev = self.device
        args = (torch.as_tensor(vals_perm, device=dev),
                torch.as_tensor(vals_perm[valid_perm], device=dev),
                torch.as_tensor(valid_perm, device=dev),
                torch.as_tensor(starts, device=dev),
                torch.as_tensor(rank, device=dev), self._generator(perm_idx))
        kw = dict(score_type=self.neighborhood_score_type,
                  num_permutations=int(self.num_permutations),
                  batch_size=_perm.default_batch_size(
                      V, A, int(self.num_permutations)),
                  w_c=w_c, precision=self.matmul_precision,
                  perm_idx=perm_idx)
        return args, kw

    # ------------------------------------------------- band binary enrichment

    @staticmethod
    def _hypergeom_host_operands(n2a, order):
        """(nan0 f32, nodes_not_nan f32, K f32) in the permuted frame for
        the band tail-loop engines, on the host (``safe.py:711``); K is
        summed in f64."""
        finite = ~np.isnan(n2a)
        nan0 = np.where(finite, n2a, 0.0).astype(np.float32)
        K = nan0.sum(axis=0, dtype=np.float64).astype(np.float32)
        nnn = np.any(finite, axis=1).astype(np.float32)
        return nan0[order], nnn[order], K

    @staticmethod
    def _hypergeom_attr_chunk(n, num_attrs, budget_elems=2 ** 24):
        """Attribute chunk of the band tail loop (``safe.py:725``): about
        ten (N, chunk) f64 intermediates are live in one chunk, so a chunk
        holds at most ``budget_elems`` cells; None = unchunked."""
        if n * num_attrs <= budget_elems:
            return None
        return int(max(64, budget_elems // max(1, n)))

    def _band_hyper_operands_cached(self, order, window_band=None):
        """(nan0 int8, nodes_not_nan, K, binary_ok, M) of the band class
        table, built on the device from the annotation upload
        (``enrich_band.band_hyper_operands_device``), or from column-chunked
        uploads where :meth:`_prep_chunked_selected`
        (``band_hyper_operands_chunked``; the same int8 operands), and
        cached across runs on the attribute load and a sha1 of ``order``
        (``safe.py:1018``). Where the values are not all 0/1 only the
        scalars are kept. With ``window_band`` (the band of a run on the
        "data" mesh) the rank's window of the operands is built instead
        (``parallel.band_sharded.band_hyper_operands_sharded``). The cached
        operands of another key are dropped before the build. A build (not
        one served from the cache) is the span ``facade.go_operands``."""
        key = (self._attr_serial, order.shape[0],
               hashlib.sha1(order.tobytes()).digest(), window_band)
        c = self._band_operands_cache
        if c is not None and c[0] == key:
            return c[1]
        self._band_operands_cache = None
        with _prof.span("facade.go_operands"):
            if window_band is not None:
                from safepy_tpu_torch.parallel.band_sharded import (
                    band_hyper_operands_sharded)
                nan0, nnn, K, binary_ok, M = band_hyper_operands_sharded(
                    self.node2attribute, order, mesh=self.mesh,
                    n=order.shape[0], band=window_band, device=self.device)
            else:
                if self._prep_chunked_selected():
                    ops = _eb.band_hyper_operands_chunked(
                        self.node2attribute, order, device=self.device)
                else:
                    ops = _eb.band_hyper_operands_device(
                        self._node2attribute_device(), order,
                        binary_ok=self._num_other_values() == 0)
                nan0, nnn, K, binary_ok = ops
                M = int(nnn.sum())
        out = (nan0 if binary_ok else None, nnn, K, binary_ok, M)
        self._band_operands_cache = (key, out)
        return out

    # ------------------------------------------------------- memory planner

    def _planned_resident_bytes(self) -> int:
        """Bytes of the session's live device tensors that a band GO plan
        counts among its peaks: the cached f32 upload, the cached int8
        operands, a stored indicator band and a kept distance band (each
        storage once)."""
        cache = self._band_operands_cache
        held = [self._n2a_dev, *(cache[1] if cache is not None else ())]
        for bm in (self._neighborhoods_dev, self._node_distances_dev):
            if isinstance(bm, BandedMatrix):
                held.append(bm.data)
        storages = {}
        for t in held:
            if isinstance(t, torch.Tensor) and self._on_device(t):
                st = t.untyped_storage()
                storages[st.data_ptr()] = st.nbytes()
        return sum(storages.values())

    def _hbm_budget(self) -> int:
        """The budget of a band GO plan: ``hbm_budget_bytes``, or the
        device's (``hbm.device_hbm_budget``) with the session's planned
        residents counted as its own."""
        if self.hbm_budget_bytes is not None:
            return int(self.hbm_budget_bytes)
        return _hbm.device_hbm_budget(
            self.device, own_bytes=self._planned_resident_bytes())

    def _prep_chunked_selected(self) -> bool:
        """Build the band GO operands (and count the non-0/1 values) from
        column-chunked uploads? Where the full-device prep's modeled peak
        (``hbm.prep_peak``) crosses :meth:`_hbm_budget` and the f32 upload
        is not already on the device. JAX keys this on
        ``annotation_release_min_bytes`` (``safe.py:1077``), a 16 GB
        chip's threshold; both preps give the same int8 operands."""
        n2a = self.node2attribute
        if self._n2a_dev is not None or n2a is None:
            return False
        return _hbm.prep_peak(*n2a.shape, chunked=False) > self._hbm_budget()

    def _band_go_hbm_guard(self, num_nodes, band, n_attrs):
        """The memory plan of a band GO run (``safe.py:916``), made before
        the operand prep: stored in ``_hbm_plan_last``, and a
        ``ValueError`` carrying it when no residency fits. The census
        residency is chosen again with the exact class table inside
        ``hypergeom_band_table`` (:meth:`_record_census_select`) against
        the same budget, ``plan["budget"]``, read here before the run
        allocates."""
        if self.logsf_store not in ("auto", "device", "f16", "host"):
            raise ValueError(f"unknown logsf_out: {self.logsf_store!r}")
        budget = self._hbm_budget()
        plan = _hbm.band_go_hbm_plan(
            num_nodes, band, n_attrs,
            packed=self._band_bits_selected(num_nodes, band),
            keep_distances=bool(self.keep_node_distances),
            logsf_out=self.logsf_store,
            prep_chunked=self._prep_chunked_selected(),
            budget=budget, edges=len(self._arrays()[1]),
            device=self.device)
        self._hbm_plan_last = plan
        if not plan["fits"]:
            raise ValueError(
                "refusing to run a band GO pipeline that does not fit the "
                "device: " + _hbm.explain(plan) + ". Levers: "
                "keep_node_distances=False, band_indicator_bits=True, "
                "logsf_store='f16'/'host', or a larger hbm_budget_bytes.")
        return plan

    def _kept_band_bytes(self) -> int:
        """Bytes of a kept f32 distance band on the device
        (``safe.py:945``)."""
        bm = self._node_distances_dev
        if (isinstance(bm, BandedMatrix) and isinstance(bm.data, torch.Tensor)
                and self._on_device(bm.data)):
            return int(bm.data.nbytes)
        return 0

    def _census_residents(self, dist_band=None) -> int:
        """Device bytes the session holds through the census besides the
        indicator band and the int8 operands: a kept f32 distance band (the
        run's, or the stored one) and the cached f32 upload."""
        kept = (int(dist_band.nbytes) if dist_band is not None
                else self._kept_band_bytes())
        return kept + (int(self._n2a_dev.nbytes)
                       if self._n2a_dev is not None else 0)

    def _record_census_select(self, sel):
        """Merge the census selection (the exact table's) into
        ``_hbm_plan_last`` (``safe.py:954``)."""
        if not sel:
            return
        if isinstance(self._hbm_plan_last, dict):
            self._hbm_plan_last = dict(self._hbm_plan_last, census_final=sel,
                                       logsf_out=sel["logsf_out"],
                                       census_peak=sel["census_peak"])
        if self.verbose and sel["logsf_out"] != "device":
            logging.info("memory plan: log-survival residency %s (census "
                         "peak %.2f GB of %.2f GB)", sel["logsf_out"],
                         sel["census_peak"] / 1e9, sel["budget"] / 1e9)

    def _band_tail_operands(self, n2a, order):
        """(nan0, nnn, K, M, iterations, lgt) of the band tail-loop engines:
        the host operands, the population and the tail's bound."""
        nan0, nnn, K = self._hypergeom_host_operands(n2a, order)
        M = int(nnn.sum())
        k_max = int(max(1, K.max())) if K.size else 1
        iters = _hyper.tail_iterations(M, min(k_max, M))
        lgt = torch.as_tensor(_hyper.lgamma_table(M), device=self.device)
        return nan0, nnn, K, M, iters, lgt

    def _band_hypergeom(self, band_fn, n, band, rank, staged=False):
        """The hypergeometric test over band storage on one device
        (``safe.py:1327-1390``, ``:1893-2047``), over the band that
        ``band_fn()`` returns as (dist_band or None, s_ind, mean, std): a
        ``run_pipeline``'s front, or the stored band of the staged test.
        The class table (``table-band``) for binary annotations within its
        budget, else the f64 tail loop in host-driven column chunks past
        ``_hypergeom_attr_chunk``'s budget (``hostchunks-band``), else
        whole (``loop-band``); the staged test's names end in ``-staged``.
        ``hypergeom_engine='loop'`` skips the table; where the table does
        not apply, 'table' takes the loop engines in a ``run_pipeline`` and
        raises in the staged test, as in JAX. The memory plan and the
        operand prep come before ``band_fn`` (``safe.py:1897-1904``).
        Returns (the band, (log sf, indicator, enriched counts)), the
        results on the device with the rows un-permuted; the NES derives
        from the log sf."""
        order = np.argsort(rank)  # permuted position -> original node
        n2a = self.node2attribute
        thr = np.float64(self.enrichment_threshold)
        bt = _bst.band_params(n, band)[0]
        prec = self.matmul_precision
        front = out = None
        if self.hypergeom_engine in ("auto", "table"):
            hbm_plan = self._band_go_hbm_guard(n, band, n2a.shape[1])
            nan0, nnn, K, binary_ok, M = \
                self._band_hyper_operands_cached(order)
            _hbm.record_peak("prep", self.device)
            if binary_ok:
                front = band_fn()
                _hbm.record_peak("relax", self.device)
                sel = {}
                with _prof.span("facade.wait", site="go_K"):
                    K_np = K.cpu().numpy()
                with _prof.span("enrichment.go"):
                    out = _eb.hypergeom_band_table(
                        front[1], nan0, nnn, M, thr, bt=bt, rank_np=rank,
                        precision=prec, logsf_out=self.logsf_store,
                        K_np=K_np, budget=hbm_plan["budget"],
                        extra_resident_bytes=self._census_residents(
                            front[0]),
                        select_out=sel)
                self._record_census_select(sel)
                _hbm.record_peak("census", self.device)
        if out is not None:
            engine = "table-band"
        elif staged and self.hypergeom_engine == "table":
            raise ValueError(
                "hypergeom_engine='table' requires binary 0/1 annotations "
                "with an in-budget class table")
        else:
            nan0, nnn, K, M, iters, lgt = self._band_tail_operands(n2a,
                                                                   order)
            attr_chunk = self._hypergeom_attr_chunk(n, n2a.shape[1])
            if front is None:
                front = band_fn()
            if attr_chunk is not None:
                engine = "hostchunks-band"
                out = _eb.hypergeom_band_hostchunks(
                    front[1], nan0, nnn, lgt, M, thr, bt=bt, rank_np=rank,
                    attr_chunk=attr_chunk, precision=prec)
            else:
                engine = "loop-band"
                dev = self.device
                log_sf32, nesbin8 = _eb.hypergeom_core_band(
                    front[1], *(torch.as_tensor(x, device=dev)
                                for x in (nan0, nnn, K)),
                    lgt, M, thr, iterations=iters, bt=bt, precision=prec,
                    rank=torch.as_tensor(rank, device=dev))
                out = (log_sf32, nesbin8,
                       nesbin8.sum(dim=0, dtype=torch.int32))
        self._hypergeom_engine_used = engine + ("-staged" if staged else "")
        return front, out

    def _band_go_shard_guard(self, num_nodes, band, n_attrs):
        """The per-rank memory plan of the row-sharded band GO engine
        (``safe.py:972-988``), made before the operand prep: stored in
        ``_hbm_plan_last``, and a ``ValueError`` carrying it when a rank's
        peak (JAX's per-shard terms and the port's transients) does not
        fit :meth:`_hbm_budget`."""
        from safepy_tpu_torch.parallel.mesh import mesh_axis
        splan = _hbm.band_go_shard_hbm_plan(
            num_nodes, band, n_attrs, mesh_axis(self.mesh, "data")[1],
            packed=self._band_bits_selected(num_nodes, band),
            keep_distances=bool(self.keep_node_distances),
            budget=self._hbm_budget(), device=self.device)
        self._hbm_plan_last = splan
        if not splan["fits"]:
            raise ValueError(
                "refusing to run a sharded band GO pipeline that does not "
                "fit per rank: " + _hbm.explain(splan) + ". A rank's "
                "device holds its slabs, its rows of the operands and "
                "outputs and one chunk's transients (the assembled bands "
                "and outputs go to host memory), so more 'data' ranks "
                "lower the peak: add ranks, set keep_node_distances=False "
                "or band_indicator_bits=True, lower the radius, or give a "
                "larger hbm_budget_bytes.")
        return splan

    def _run_pipeline_band_hypergeom_sharded(self, plan, nr):
        """run_pipeline's binary branch over band storage on a "data" mesh
        (``safe.py:1893-2031``): the row-sharded FW front, then the class
        table (``table-band-sharded``) for binary annotations, else the
        f64 tail loop fused with its own front (``loop-band-sharded``:
        ``hypergeom_engine='loop'``, values that are not 0/1, or a table
        over its budget). As in JAX the FW always relaxes the band and
        ``logsf_store`` is not read; the per-rank plan
        (:meth:`_band_go_shard_guard`) comes before the operand prep, and
        each rank builds only its window of the operands.

        The results, the same on every rank, live in host memory: the
        bands and the (n, A) log sf and indicator, assembled a rank's
        segment at a time (JAX keeps them row-sharded over the devices,
        ``safepy_tpu/parallel/band_sharded.py:742-784``), so that no card
        holds more than its rank's share and adding ranks lowers each
        rank's peak. They are stored as the 'host' residency stores them
        (FDR on the host, ``fdr_bh_logsf_np``); a later stage that
        computes on them uploads what it reads (:meth:`_band_device`,
        :meth:`_nes_binary_on_device`, :meth:`_nes_on_device`)."""
        from safepy_tpu_torch.parallel import band_sharded as _bsh
        from safepy_tpu_torch.parallel.mesh import mesh_axis
        num_nodes = self._num_nodes
        band, rank = plan["band"], plan["rank"]
        self._release_device_results()
        self._n2a_dev = None  # the mesh path reads the host matrix
        order = np.argsort(rank)  # permuted position -> original node
        n2a = self.node2attribute
        radius = _nbr.inclusive_radius(nr)
        thr = np.float64(self.enrichment_threshold)
        kw = dict(mesh=self.mesh, n=num_nodes, band=band)
        packed = self._band_bits_selected(num_nodes, band)
        keep = bool(self.keep_node_distances)
        edges = (plan["u"], plan["v"], plan["w"])
        self._band_relax_used = "fw"

        table_out = None
        if self.hypergeom_engine in ("auto", "table"):
            self._band_go_shard_guard(num_nodes, band, n2a.shape[1])
            nan0, nnn, K, binary_ok, M = \
                self._band_hyper_operands_cached(order, window_band=band)
            _hbm.record_peak("prep", self.device)
            if binary_ok:
                dist_band, s_ind, _sizes, mean, std = \
                    _bsh.band_neighborhoods_sharded(
                        *edges, radius, keep_distances=keep, packed=packed,
                        **kw)
                _hbm.record_peak("relax", self.device)
                table_out = _bsh.hypergeom_band_table_sharded(
                    s_ind, nan0, nnn, M, thr, rank_np=rank,
                    precision=self.matmul_precision, K_np=K.cpu().numpy(),
                    **kw)
                _hbm.record_peak("census", self.device)
        if table_out is not None:
            self._hypergeom_engine_used = "table-band-sharded"
            log_sf32, nesbin8, counts = table_out
        else:
            self._hypergeom_engine_used = "loop-band-sharded"
            dist_band = s_ind = None  # the loop runs its own front
            nan0, nnn, K, M, iters, lgt = self._band_tail_operands(n2a,
                                                                   order)
            rows = -(-num_nodes // mesh_axis(self.mesh, "data")[1])
            (dist_band, s_ind, log_sf32, nesbin8, counts, mean, std) = \
                _bsh.fused_hypergeom_pipeline_band_sharded(
                    *edges, nan0, nnn, K, lgt, M, radius, thr,
                    plan["rank_dev"], iterations=iters,
                    precision=self.matmul_precision, keep_distances=keep,
                    packed=packed,
                    attr_chunk=self._hypergeom_attr_chunk(rows,
                                                          n2a.shape[1]),
                    **kw)
        self._end_band_run(plan, (dist_band, s_ind, mean, std),
                           self._store_hypergeom_results, None,
                           log_sf32.numpy(), nesbin8.numpy(), counts)

    # --------------------------------------------------------------- domains

    def _nes_binary_small(self):
        """The binary indicator without the public property's f64 copy
        (``safe.py:2149-2164``): the host matrix where one was set, else the
        device indicator's int8 download, made once."""
        if self._nes_binary_np is not None:
            return self._nes_binary_np
        if self._nes_binary_pending is not None:
            self._update_binary_enrichment()
        if self._nes_binary_dev is not None and self._nes_binary_i8_np is None:
            self._nes_binary_i8_np = self._nes_binary_dev.cpu().numpy()
        if self._nes_binary_i8_np is not None:
            return self._nes_binary_i8_np
        return self.nes_binary

    def _nes_column(self, j):
        """NES column ``j`` in f64, without the (N, A) host matrix
        (``safe.py:2166-2199``): the host NES, else the pickled log-survival,
        else one column of the deferred log-survival sliced on the device
        (the f64 divide and f32 round of :meth:`_nes_device`), else one
        column of the device NES. The plots read it. N values cross to the
        host."""
        if self._nes_np is not None:
            return np.asarray(self._nes_np[:, j], dtype=np.float64)
        if self._nes_from_logsf and self._logsf_np is not None:
            return _nes_from_logsf_host(self._logsf_np[:, j])
        if (self._nes_dev is None and self._nes_from_logsf
                and self._logsf_dev is not None):
            j = _column_index(j, self._logsf_dev.shape[1])
            col = (-self._logsf_dev[:, j].to(torch.float64)
                   / np.log(10.0)).to(torch.float32)
            return col.cpu().numpy().astype(np.float64)
        if self._nes_dev is not None:
            j = _column_index(j, self._nes_dev.shape[1])
            return self._nes_dev[:, j].cpu().numpy().astype(np.float64)
        return np.asarray(self.nes[:, j], dtype=np.float64)

    def _nes_binary_column(self, j):
        """Indicator column ``j`` (``safe.py:2201-2219``): the host matrix,
        else its int8 download, else one column sliced on the device."""
        if self._nes_binary_np is not None:
            return np.asarray(self._nes_binary_np[:, j])
        if self._nes_binary_i8_np is not None:
            return np.asarray(self._nes_binary_i8_np[:, j])
        if self._nes_binary_pending is not None:
            self._update_binary_enrichment()
        if self._nes_binary_dev is not None:
            j = _column_index(j, self._nes_binary_dev.shape[1])
            return self._nes_binary_dev[:, j].cpu().numpy()
        return np.asarray(self.nes_binary[:, j])

    def _nes_binary_for_top(self):
        """The indicator for define_top_attributes (``safe.py:2219-2241``):
        the CSC view of a device indicator of more than 3e7 cells, fewer
        than a quarter of them nonzero, under int32 indexing; else
        :meth:`_nes_binary_small`."""
        if self._nes_binary_pending is not None:
            self._update_binary_enrichment()
        if (self._nes_binary_np is None and self._nes_binary_i8_np is None
                and self._nes_binary_dev is not None
                and "num_neighborhoods_enriched" in self.attributes):
            if self._nes_binary_csc is not None:
                return self._nes_binary_csc
            n, a = self._nes_binary_dev.shape
            counts = np.asarray(
                self.attributes["num_neighborhoods_enriched"], np.int64)
            if (n * a > 3e7 and 4 * int(counts.sum()) < n * a
                    and n * a < np.iinfo(np.int32).max):
                self._nes_binary_csc = _dd.indicator_csc(
                    self._nes_binary_on_device(), counts)
                return self._nes_binary_csc
        return self._nes_binary_small()

    def _take_kwargs(self, kwargs, names):
        """Set the settings of ``names`` that ``kwargs`` holds and check
        them; other names are ignored, as in JAX (``safe.py:2243-2258``)."""
        for k in names:
            if k in kwargs:
                setattr(self, k, kwargs[k])
        self._validate()

    def define_top_attributes(self, **kwargs):
        """Mark the top attributes (``safe.py:2243``): enough enriched
        neighborhoods, and one connected component of them in the network
        (the 'connectivity' unimodality metric)."""
        self._take_kwargs(kwargs, ("attribute_unimodality_metric",
                                   "attribute_enrichment_min_size"))
        if (self.attributes is None
                or "num_neighborhoods_enriched" not in self.attributes):
            raise RuntimeError("compute_pvalues (or run_pipeline) first")
        # an edgeless scatter input: connectivity over the euclidean
        # pseudo-network (domains.py:49-50)
        edges = (self._arrays()[1] if self.graph_euclidean is None
                 else self.graph_euclidean.edges)
        self.attributes = _domains.define_top_attributes(
            self.attributes, self._nes_binary_for_top(), edges,
            self._num_nodes,
            unimodality_metric=self.attribute_unimodality_metric,
            min_size=self.attribute_enrichment_min_size, verbose=self.verbose)

    def define_domains(self, **kwargs):
        """Cluster the top attributes into domains and give each node its
        primary domain (``safe.py:2256``). The intersection GEMM reads the
        device indicator and is cached across re-clusterings at other
        thresholds; the host NES and indicator are read only by the scipy
        engine."""
        self._take_kwargs(kwargs, ("attribute_distance_threshold",))
        if self.attributes is None or "top" not in self.attributes:
            raise RuntimeError("define_top_attributes first")
        if self._nes_binary_pending is not None:
            self._update_binary_enrichment()
        # the GEMM engine computes on the device: a host indicator or
        # log-survival (a mesh run, the 'host' residency) is uploaded
        gemm = (self.attribute_distance_metric == "jaccard"
                and _domains.uses_gemm(self.cluster_engine, "jaccard",
                                       int(np.sum(self.attributes["top"]))))
        b_dev = self._nes_binary_on_device() if gemm else None
        if self._domains_inter_cache is None and b_dev is not None:
            self._domains_inter_cache = _dd.enrichment_intersections(b_dev)
        self.attributes, self.node2domain = _domains.define_domains(
            self.attributes, lambda: self.nes, self._nes_binary_small,
            distance_metric=self.attribute_distance_metric,
            distance_threshold=self.attribute_distance_threshold,
            verbose=self.verbose, cluster_engine=self.cluster_engine,
            intersections=self._domains_inter_cache, nes_binary_dev=b_dev,
            nes_dev=self._nes_on_device() if gemm else None,
            device=self.device)
        # after the call, which resolves a pending indicator (safe.py:2282)
        self._node2domain_serial = self._enrichment_serial

    def trim_domains(self, **kwargs):
        """Drop the domains that are primary for fewer than
        ``attribute_enrichment_min_size`` nodes, renumber and label the rest
        (``safe.py:2283``); sets ``domains``. It reads no keyword argument
        and checks no setting, as in JAX (``safe.py:2284-2287``)."""
        if self.node2domain is None:
            raise RuntimeError("define_domains first")
        self.attributes, self.node2domain, self.domains = \
            _domains.trim_domains(
                self.attributes, self.node2domain,
                min_size=self.attribute_enrichment_min_size,
                verbose=self.verbose)

    # -------------------------------------------------------------- plotting
    # matplotlib is imported on the first plot (safe.py:2291-2307)

    def plot_network(self, **kwargs):
        from safepy_tpu_torch import plotting
        return plotting.plot_safe_network(self, **kwargs)

    def plot_composite_network(self, **kwargs):
        from safepy_tpu_torch import plotting
        return plotting.plot_composite_network(self, **kwargs)

    def plot_composite_network_contours(self, **kwargs):
        from safepy_tpu_torch import plotting
        return plotting.plot_composite_network_contours(self, **kwargs)

    def plot_sample_attributes(self, **kwargs):
        from safepy_tpu_torch import plotting
        return plotting.plot_sample_attributes(self, **kwargs)

    # ---------------------------------------------------------------- output

    def print_output_files(self, **kwargs):
        """The three TSV reports into ``output_dir`` (``safe.py:2309``,
        ``output.py``)."""
        _output.print_output_files(self, **kwargs)

    # ------------------------------------------------------------ pickling

    def __getstate__(self):
        """What ``save`` pickles (``safe.py:1122-1160``): numpy only, and
        ``device`` as its string, so that a session saved on the card loads
        where there is none.

        - The statistics in their compact forms: the f32 log-survival and
          the int8 indicator of a device run (``pvalues_pos``,
          ``nes_binary`` and a deferred NES derive from them after loading,
          bitwise as from the device); a device NES as its f64 download.
        - Band-stored matrices as their bands (through
          :meth:`BandedMatrix.to_host`), never dense; dense device matrices
          as the host views.
        - No device result, operand cache, plan or mesh: the stages rebuild
          them on the session's device.
        """
        band_nbr = isinstance(self._neighborhoods_dev, BandedMatrix)
        band_dist = isinstance(self._node_distances_dev, BandedMatrix)
        if not band_nbr:
            _ = self.neighborhoods, self.node_distances
        if self._nes_binary_pending is not None:
            self._update_binary_enrichment()
        if not self._nes_from_logsf:
            _ = self.nes
        state = dict(self.__dict__)
        if self._logsf_dev is not None:
            state["_logsf_np"] = self._logsf_dev.cpu().numpy()
            # derived from it, bitwise, after loading
            state["_pvalues_pos_np"] = None
            if self._nes_from_logsf:
                state["_nes_np"] = None
        if self._nes_binary_dev is not None:
            state["_nes_binary_i8_np"] = (
                self._nes_binary_i8_np if self._nes_binary_i8_np is not None
                else self._nes_binary_dev.cpu().numpy())
            state["_nes_binary_np"] = None
        # a band's dense views derive from it (and may not fit a host)
        if band_nbr:
            state["_neighborhoods_np"] = None
        if band_dist:
            state["_node_distances_np"] = None
        state["_neighborhoods_dev"] = (
            _band_to_numpy(self._neighborhoods_dev) if band_nbr else None)
        state["_node_distances_dev"] = (
            _band_to_numpy(self._node_distances_dev) if band_dist else None)
        state.update(_logsf_dev=None, _nes_dev=None, _nes_binary_dev=None,
                     _n2a_dev=None, _band_operands_cache=None,
                     _nes_binary_pending=None, _domains_inter_cache=None,
                     _nes_binary_csc=None, _d0_cache={}, _banded_cache={},
                     _bandstore_cache={}, _graph_arrays=None, mesh=None,
                     device=str(self.device))
        return state

    def __setstate__(self, state):
        """The pickled state, with the defaults of what it predates
        (``safe.py:1162-1182``); ``device`` back to a ``torch.device``
        without touching it: a stage that needs the card raises where
        there is none, and the host views serve from the pickled arrays."""
        self.__dict__.update(state)
        for name, value in _PICKLE_DEFAULTS.items():
            self.__dict__.setdefault(name, value)
        for name in ("_d0_cache", "_banded_cache", "_bandstore_cache"):
            self.__dict__.setdefault(name, {})
        self.device = torch.device(self.device)


def run_safe_batch(attribute_file):
    """One worker of the batch CLI (``safe.py:2314-2323``): the whole
    analysis of one attribute file on the card, from the default INI's
    network; returns the NES. The CLI's own worker is
    :func:`safepy_tpu_torch.cli.run_safe_batch`."""
    sf = SAFE()
    sf.load_network()
    sf.define_neighborhoods()
    sf.load_attributes(attribute_file=attribute_file)
    sf.compute_pvalues(num_permutations=1000)
    return sf.nes


# The reference's namespace: its `safe` module star-imports its io, extras
# and colormap helpers (safe.py:2326-2339), so user code reaches them as
# `safe.<name>`. The plotting names and MidpointRangeNormalize import
# matplotlib, so they resolve on first access (__getattr__ below).
from safepy_tpu_torch.colormaps import get_colors  # noqa: E402,F401
from safepy_tpu_torch.io import (apply_network_layout,  # noqa: E402,F401
                                 calculate_edge_lengths, chop_and_filter,
                                 load_mat, load_network_from_cys,
                                 load_network_from_gpickle,
                                 load_network_from_mat,
                                 load_network_from_scatter,
                                 load_network_from_txt, read_attributes)

_PLOTTING_NAMES = ("mark_nodes", "plot_network", "plot_network_contour",
                   "plot_costanzo2016_network_annotations")


def __getattr__(name):
    if name in _PLOTTING_NAMES:
        from safepy_tpu_torch import plotting
        return getattr(plotting, name)
    if name == "MidpointRangeNormalize":
        from safepy_tpu_torch import colormaps
        return colormaps.MidpointRangeNormalize
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def run_permutations(arg_tuple, **kwargs):
    """The reference's permutation worker (``safe.py:2342-2364``,
    reference ``safe_extras.py:36-70``): takes the pool's argument tuple
    ``(neighborhoods, node2attribute, score_type, num_permutations,
    random_seed)`` and returns the two-sided counts as f64 numpy. The
    operands compute where ``ops`` puts them: on the device of a tensor
    ``neighborhoods``, else on the card. The torch random stream differs
    from JAX's, as the reference's shuffles differ from both
    (ops/permutation.py). Other keyword arguments are ignored, as in JAX."""
    (neighborhood2node, node2attribute, neighborhood_score_type,
     num_permutations, random_seed) = arg_tuple
    n2a_np = np.asarray(node2attribute, dtype=np.float64)
    nbr, n2a = on_device("run_permutations", neighborhood2node, n2a_np)
    nbr = nbr.to(torch.float32)
    obs = compute_neighborhood_score(nbr, n2a, neighborhood_score_type)
    valid_rows = np.flatnonzero(np.sum(~np.isnan(n2a_np), axis=1))
    valid = (None if len(valid_rows) == n2a_np.shape[0]
             else torch.as_tensor(valid_rows, device=nbr.device))
    if random_seed is None:
        random_seed = int(np.random.default_rng().integers(2 ** 31 - 1))
    generator = torch.Generator(device=nbr.device).manual_seed(
        int(random_seed))
    counts_neg, counts_pos = _perm.run_permutations(
        nbr, n2a, valid, obs, generator=generator,
        score_type=neighborhood_score_type,
        num_permutations=int(num_permutations))
    return (counts_neg.cpu().numpy().astype(np.float64),
            counts_pos.cpu().numpy().astype(np.float64))
