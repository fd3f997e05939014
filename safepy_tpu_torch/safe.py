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
- With ``mesh`` set to a DeviceMesh of one ``"data"`` axis
  (``parallel.make_mesh({"data": world})``, one device per rank, every rank
  running the same calls), a quantitative run that takes band storage goes
  through the row-sharded band engine (``parallel.band_sharded``,
  ``safe.py:2073``) and every rank gets the same global results.

Everything else the JAX facade offers raises ``NotImplementedError`` naming
the ROADMAP item that brings it, before anything is computed; nothing
quietly takes another path.

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
from safepy_tpu_torch import output as _output
from safepy_tpu_torch import pipeline as _pipe
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
from safepy_tpu_torch.ops.apsp_bandstore import BandedMatrix
from safepy_tpu_torch.ops.permutation import (default_batch_size,
                                              run_permutations)
from safepy_tpu_torch.ops.score import (check_fp32_matmul,
                                        compute_neighborhood_score)


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported to safepy_tpu_torch "
                               f"yet: ROADMAP {item}")


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
        # (safe.py:161): 'auto' and 'device' keep f32 on the device; the
        # f16 and host residencies wait for the memory planner (ROADMAP A8)
        self.logsf_store = "auto"
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
        if self._n2a_dev is None:
            self._n2a_dev = torch.as_tensor(
                np.asarray(self.node2attribute, np.float32), device=self.device)
        return self._n2a_dev

    def _num_other_values(self) -> int:
        """Count of finite non-0/1 annotation values (``safe.py:1087``),
        counted on the f32 values the device gets, as the JAX facade counts
        on its f32 upload (``:1102-1105``): 1 + 1e-9 rounds to 1 and 1e39
        overflows to inf. Cached until the attributes change."""
        if self._num_other_cache is None:
            with np.errstate(over="ignore"):
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
        if self._nes_np is None and self._nes_device() is not None:
            self._nes_np = self._nes_dev.cpu().numpy().astype(np.float64)
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

    @property
    def pvalues_pos(self):
        if self._pvalues_pos_np is None and self._logsf_dev is not None:
            log_sf = self._logsf_dev.cpu().numpy().astype(np.float64)
            with np.errstate(over="ignore"):
                self._pvalues_pos_np = np.exp(log_sf)
        return self._pvalues_pos_np

    @pvalues_pos.setter
    def pvalues_pos(self, value):
        self._pvalues_pos_np = value
        self._logsf_dev = None

    @property
    def nes_binary(self):
        if self._nes_binary_np is None and self._nes_binary_dev is not None:
            self._nes_binary_np = self._nes_binary_small().astype(float)
        return self._nes_binary_np

    @nes_binary.setter
    def nes_binary(self, value):
        self._nes_binary_np = value
        self._nes_binary_dev = None
        self._nes_binary_i8_np = None
        self._nes_binary_csc = None
        self._domains_inter_cache = None

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

    def _release_device_results(self):
        """Drop the previous run's device matrices before computing new ones
        (``safe.py:1392``): a stale band or (N, A) result would otherwise
        share the device with the new run's until reassigned."""
        self._neighborhoods_dev = self._node_distances_dev = None
        self._neighborhoods_np = self._node_distances_np = None
        self._nes_dev = self._logsf_dev = self._nes_binary_dev = None
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
        bt = -(-(band // block + 1) // bucket) * bucket
        return bt * block - 1

    def _band_bits_selected(self, num_nodes, band):
        """Bit-pack the indicator band (``safe.py:990``)?"""
        if self.band_indicator_bits == "auto":
            return (_bst.band_nbytes(num_nodes, band, itemsize=1)
                    >= float(self.band_bits_min_bytes))
        return bool(self.band_indicator_bits)

    def _data_mesh(self) -> bool:
        """Is ``mesh`` a DeviceMesh of exactly one axis, named "data"?"""
        return (getattr(self.mesh, "mesh_dim_names", None) == ("data",)
                and self.mesh.ndim == 1)

    def _refuse_unported(self):
        if self.mesh is not None and not self._data_mesh():
            raise _not_ported("a mesh other than one 'data' axis (the "
                              "'perm' and 'attr' axes, 2-D meshes)",
                              "A10 remainder")

    def _refuse_mesh(self, what: str):
        if self.mesh is not None:
            raise _not_ported(f"{what} on a mesh (the sharded dense and "
                              "hypergeometric engines)", "A10 remainder")

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
        self._refuse_mesh("define_neighborhoods")
        self._refuse_unported()

        num_nodes = self._num_nodes
        coords, edges, lengths, edge_weights = self._graph_arrays
        nr, weights = self._radius(coords, lengths, edge_weights)
        if self.node_distance_metric == "euclidean":
            eb_plan = self._euclidean_band_plan(coords, num_nodes, nr)
            if eb_plan is not None:
                rank, band = eb_plan["rank"], eb_plan["band"]
                keep = bool(self.keep_node_distances)
                # drop the previous bands before building new ones
                self._neighborhoods_dev = self._node_distances_dev = None
                dist_band, s_ind, mean, std = \
                    _pipe.euclidean_band_neighborhoods(
                        torch.as_tensor(coords[np.argsort(rank)],
                                        dtype=torch.float32,
                                        device=self.device),
                        np.float32(nr), n=num_nodes, band=band,
                        keep_distances=keep,
                        packed=(not keep and self._band_bits_selected(
                            num_nodes, band)))
                self.apsp_engine_used, self.window_used = "band-storage", None
                return self._store_band_neighborhoods(
                    s_ind, dist_band, rank, band, mean, std)
            dist = _nbr.euclidean_distance_matrix(torch.as_tensor(
                coords, dtype=torch.float32, device=self.device))
            nbr, mean, std = _nbr.threshold_and_stats(dist, np.float32(nr),
                                                      strict=True)
            self.apsp_engine_used, self.window_used = "euclidean", None
            return self._store_neighborhoods(nbr, dist, mean, std)

        radius = _nbr.inclusive_radius(nr)
        bs_plan = self._band_storage_plan(coords, edges, weights, num_nodes,
                                          nr)
        if bs_plan is not None:
            # drop the previous bands before building new ones
            self._neighborhoods_dev = self._node_distances_dev = None
            dist_band, s_ind, mean, std = self._band_front_dispatch(
                bs_plan, radius, num_nodes)
            self.apsp_engine_used, self.window_used = "band-storage", None
            return self._store_band_neighborhoods(
                s_ind, dist_band, bs_plan["rank"], bs_plan["band"], mean, std)
        d0, inv_rank, window = self._dense_front(coords, edges, weights,
                                                 num_nodes, nr)
        dist = _pipe._apsp_inline(d0, 128, window=window, inv_rank=inv_rank,
                                  radius=radius)
        nbr, mean, std = _nbr.threshold_and_stats(dist, radius, strict=False)
        self._store_neighborhoods(nbr, dist, mean, std)

    def _dense_front(self, coords, edges, weights, num_nodes, nr):
        """(d0, inv_rank, window) of the banded window when its plan holds,
        else the cached dense FW initialization (inv_rank, window None), and
        the engine recorded."""
        plan = self._banded_plan(coords, edges, weights, num_nodes, nr)
        if plan is not None:
            d0, inv_rank, window = plan
            self.apsp_engine_used, self.window_used = "banded-window", window
            return d0, inv_rank, window
        d0 = self._d0_cache.get(self.node_distance_metric)
        if d0 is None:
            d0 = _nbr.initial_distances_device(num_nodes, edges, weights,
                                               device=self.device)
            self._d0_cache[self.node_distance_metric] = d0
        self.apsp_engine_used, self.window_used = "dense", None
        return d0, None, None

    def _store_band_neighborhoods(self, s_ind, dist_band, rank, band, mean,
                                  std):
        """:meth:`_store_neighborhoods` of an indicator band and a distance
        band (or None), wrapped with their frame."""
        n = self._num_nodes
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
        self._refuse_mesh("compute_pvalues")
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
        in JAX. Over band storage: :meth:`_hypergeom_bandstore`."""
        self._log_kwargs(kwargs, "Overwriting global settings:")
        self._validate()
        self._refuse_mesh("compute_pvalues_by_hypergeom")
        if self.verbose:
            logging.info("Using the hypergeometric test to calculate "
                         "enrichment...")
        n2a = self.node2attribute
        if isinstance(self._neighborhoods_dev, BandedMatrix):
            return self._hypergeom_bandstore(self._neighborhoods_dev, n2a)
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
        the NES then derives from it on first read."""
        if self.multiple_testing:
            if self.verbose:
                logging.info("Running FDR-adjustment of p-values...")
            log_sf32, nes_binary8, counts = _fdr.fdr_bh_logsf(
                log_sf32, np.log(self.enrichment_threshold),
                row_chunk=self._fdr_row_chunk(tuple(log_sf32.shape)))
            nes32 = None
        self._pvalues_pos_np = None
        self._nes_np = None
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
        instead of the session's generator."""
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
        self._refuse_mesh("compute_pvalues_by_randomization")

        if isinstance(self._neighborhoods_dev, BandedMatrix):
            return self._randomization_bandstore(self._neighborhoods_dev,
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
        counts_neg, counts_pos = run_permutations(
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
        self.ns = obs.cpu().numpy()
        self.counts_neg = counts_neg.cpu().numpy()
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
        coords, edges, lengths, edge_weights = self._graph_arrays
        self._refuse_unported()
        binary = self._binary()
        euclid = self.node_distance_metric == "euclidean"
        staged = euclid or self.background == "network"
        if euclid and self.mesh is not None:
            raise _not_ported("the euclidean metric on a mesh (the sharded "
                              "euclidean band pipeline)", "A10 remainder")
        if staged or binary:
            self._refuse_mesh("binary (hypergeometric) enrichment and the "
                              "stage methods")
        nr, weights = self._radius(coords, lengths, edge_weights)
        bs_plan = None
        if euclid:
            eb_plan = (None if binary or self.background == "network"
                       else self._euclidean_band_plan(coords, num_nodes, nr))
            if eb_plan is not None:
                return self._run_pipeline_band_euclid(eb_plan, coords, nr,
                                                      perm_idx)
        else:
            bs_plan = self._band_storage_plan(coords, edges, weights,
                                              num_nodes, nr)
        if staged:
            self.define_neighborhoods()
            self.compute_pvalues(perm_idx=perm_idx)
            return
        if bs_plan is not None and binary:
            return self._run_pipeline_band_hypergeom(bs_plan, nr)
        if bs_plan is not None:
            return self._run_pipeline_bandstore(bs_plan, nr, perm_idx)
        if self.mesh is not None:
            raise _not_ported("a mesh where no band-storage plan is taken "
                              "(the sharded dense engines apsp_sharded, "
                              "apsp_sharded_2d)", "A10 remainder")
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
        generator = self._generator(perm_idx)
        batch = default_batch_size(V, A, int(self.num_permutations))
        (dist, nbr, obs, counts_neg, counts_pos, mean, std) = \
            _pipe.fused_permutation_pipeline(
                d0, self._node2attribute_device(), valid_dev, generator,
                radius, score_type=self.neighborhood_score_type,
                num_permutations=int(self.num_permutations),
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
                window=window, inv_rank=inv_rank, **table_kw)
        self._store_hypergeom_results(nes32, log_sf32, nesbin8, counts_dev)
        return dist, nbr, mean, std

    def _generator(self, perm_idx):
        """The null's torch.Generator from ``random_seed`` (a fresh seed
        when None), or None when explicit permutations are given. On a mesh
        a fresh seed is drawn by the axis' first rank and shared, so that
        every rank draws the same permutations."""
        if perm_idx is not None:
            return None
        seed = self.random_seed
        if seed is None:
            seed = int(np.random.default_rng().integers(2 ** 31 - 1))
            if self.mesh is not None:
                from safepy_tpu_torch.parallel.mesh import shared_seed
                seed = shared_seed(seed, self.mesh, "data", self.device)
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def _store_results(self, obs, counts_neg, counts_pos, nbr, dist, mean,
                       std):
        """A fused quantitative run's results: scores, counts and p-values
        to the host; the neighborhoods and distances stay where the run left
        them (dense tensors or bands)."""
        self._store_null(obs, counts_neg, counts_pos)
        self._store_neighborhoods(nbr, dist, mean, std)
        self._update_binary_enrichment()

    def _run_pipeline_bandstore(self, plan, nr, perm_idx):
        """run_pipeline over the band-storage engine, quantitative branch
        (``safe.py:2048-2145``): every matrix is O(N W); the neighborhoods
        and distances become :class:`BandedMatrix` results. On a "data" mesh
        the row-sharded engine runs (``safe.py:2073-2082``) and its bands,
        assembled on every rank, lose their device-padding rows
        (``safe.py:2122-2127``)."""
        num_nodes = self._num_nodes
        band, rank = plan["band"], plan["rank"]
        packed = self._band_bits_selected(num_nodes, band)
        if self.mesh is not None and packed:
            raise _not_ported("a bit-packed indicator band on a mesh (the "
                              "sharded band engine packs no band)",
                              "A10 remainder")
        self._release_device_results()
        bt = band // 128 + 1
        tail_args, kw = self._band_null_operands(rank, bt, perm_idx)
        args = ((plan["u"], plan["v"], plan["w"]) + tail_args
                + (_nbr.inclusive_radius(nr),))
        kw.update(n=num_nodes, band=band,
                  keep_distances=bool(self.keep_node_distances))
        if self.mesh is None:
            bf = self._band_bf_args(plan)
            out = _pipe.fused_permutation_pipeline_band(
                *args, packed=packed, **kw, **bf)
            if bf and not out[7]:
                self._band_relax_used = "bf->fw"
                logging.info("band BF relax hit its iteration budget; "
                             "re-dispatching Floyd-Warshall")
                del out
                out = _pipe.fused_permutation_pipeline_band(
                    *args, packed=packed, **kw)
            else:
                self._band_relax_used = "bf" if bf else "fw"
            (dist_band, s_ind, obs, counts_neg, counts_pos, mean,
             std) = out[:7]
        else:
            from safepy_tpu_torch.parallel.band_sharded import (
                fused_permutation_pipeline_band_sharded)
            (dist_band, s_ind, obs, counts_neg, counts_pos, mean, std) = \
                fused_permutation_pipeline_band_sharded(*args, mesh=self.mesh,
                                                        **kw)
            g_rows = (-(-num_nodes // 128) + 2 * bt) * 128
            s_ind = s_ind[:g_rows]
            if dist_band is not None:
                dist_band = dist_band[:g_rows]
            self._band_relax_used = "fw"  # the sharded engine relaxes by FW
        self.apsp_engine_used, self.window_used = "band-storage", None
        self._store_null(obs, counts_neg, counts_pos)
        self._store_band_neighborhoods(s_ind, dist_band, rank, band, mean,
                                       std)
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
                  batch_size=default_batch_size(V, A,
                                                int(self.num_permutations)),
                  w_c=w_c, precision=self.matmul_precision,
                  perm_idx=perm_idx)
        return args, kw

    def _run_pipeline_band_euclid(self, plan, coords, nr, perm_idx):
        """run_pipeline's quantitative branch for the euclidean metric at
        band-storage scale (``safe.py:1795``): the band straight from the
        coordinates, then the scores and the permutation null over it, with
        no graph algorithm. Without kept distances the indicator is built
        directly, bit-packed when ``_band_bits_selected``."""
        num_nodes = self._num_nodes
        band, rank = plan["band"], plan["rank"]
        self._release_device_results()
        bt = band // 128 + 1
        keep = bool(self.keep_node_distances)
        tail_args, kw = self._band_null_operands(rank, bt, perm_idx)
        (dist_band, s_ind, obs, counts_neg, counts_pos, mean, std) = \
            _pipe.fused_permutation_pipeline_band_euclid(
                torch.as_tensor(coords[np.argsort(rank)],
                                dtype=torch.float32, device=self.device),
                *tail_args, np.float32(nr), n=num_nodes, band=band,
                keep_distances=keep,
                packed=not keep and self._band_bits_selected(num_nodes, band),
                **kw)
        self.apsp_engine_used, self.window_used = "band-storage", None
        self._store_null(obs, counts_neg, counts_pos)
        self._store_band_neighborhoods(s_ind, dist_band, rank, band, mean,
                                       std)
        self._update_binary_enrichment()

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

    def _band_hyper_operands_cached(self, order):
        """(nan0 int8, nodes_not_nan, K, binary_ok, M) of the band class
        table, built on the device from the annotation upload
        (``enrich_band.band_hyper_operands_device``) and cached across runs
        on the attribute load and a sha1 of ``order`` (``safe.py:1018``).
        Where the values are not all 0/1 only the scalars are kept."""
        key = (self._attr_serial, order.shape[0],
               hashlib.sha1(order.tobytes()).digest())
        c = self._band_operands_cache
        if c is not None and c[0] == key:
            return c[1]
        nan0, nnn, K, binary_ok = _eb.band_hyper_operands_device(
            self._node2attribute_device(), order)
        M = int(nnn.sum())
        out = (nan0 if binary_ok else None, nnn, K, binary_ok, M)
        self._band_operands_cache = (key, out)
        return out

    def _table_logsf_out(self) -> str:
        """The class table's ``logsf_out`` for ``logsf_store``: 'auto' and
        'device' keep the log-survival on the device. JAX's 'auto' chooses
        the residency by its memory planner, and 'f16' / 'host' are that
        planner's levers (ROADMAP A8)."""
        if self.logsf_store in ("f16", "host"):
            raise _not_ported(f"logsf_store={self.logsf_store!r} in the "
                              "facade (the memory planner's residencies)",
                              "A8")
        if self.logsf_store not in ("auto", "device"):
            raise ValueError(f"unknown logsf_out: {self.logsf_store!r}")
        return "device"

    def _band_tail_operands(self, n2a, order):
        """(nan0, nnn, K, M, iterations, lgt) of the band tail-loop engines:
        the host operands, the population and the tail's bound."""
        nan0, nnn, K = self._hypergeom_host_operands(n2a, order)
        M = int(nnn.sum())
        k_max = int(max(1, K.max())) if K.size else 1
        iters = _hyper.tail_iterations(M, min(k_max, M))
        lgt = torch.as_tensor(_hyper.lgamma_table(M), device=self.device)
        return nan0, nnn, K, M, iters, lgt

    def _run_pipeline_band_hypergeom(self, plan, nr):
        """run_pipeline's binary branch over band storage, one device
        (``safe.py:1893-2047``): the class table (``table-band``) for
        binary annotations within its budget, else the f64 tail loop in
        host-driven column chunks past ``_hypergeom_attr_chunk``'s budget
        (``hostchunks-band``), else fused with the band front
        (``loop-band``). ``hypergeom_engine='loop'`` skips the table; where
        the table does not apply, 'table' takes the loop engines as in JAX.
        The front takes ``band_relax`` and ``band_indicator_bits``
        (:meth:`_band_front_dispatch`). The results stay on the device; the
        NES derives from the log sf."""
        num_nodes = self._num_nodes
        band, rank = plan["band"], plan["rank"]
        self._release_device_results()
        order = np.argsort(rank)  # permuted position -> original node
        bt = band // 128 + 1
        n2a = self.node2attribute
        radius = _nbr.inclusive_radius(nr)
        thr = np.float64(self.enrichment_threshold)

        def front():
            return self._band_front_dispatch(plan, radius, num_nodes)

        table_out = done = None
        if self.hypergeom_engine in ("auto", "table"):
            logsf_out = self._table_logsf_out()
            nan0, nnn, K, binary_ok, M = \
                self._band_hyper_operands_cached(order)
            if binary_ok:
                done = front()
                table_out = _eb.hypergeom_band_table(
                    done[1], nan0, nnn, M, thr, bt=bt, rank_np=rank,
                    precision=self.matmul_precision, logsf_out=logsf_out,
                    K_np=K.cpu().numpy())
        attr_chunk = self._hypergeom_attr_chunk(num_nodes, n2a.shape[1])
        if table_out is not None:
            self._hypergeom_engine_used = "table-band"
            dist_band, s_ind, mean, std = done
            log_sf32, nesbin8, counts = table_out
        else:
            nan0, nnn, K, M, iters, lgt = self._band_tail_operands(n2a,
                                                                   order)
            if attr_chunk is not None:
                self._hypergeom_engine_used = "hostchunks-band"
                dist_band, s_ind, mean, std = done or front()
                log_sf32, nesbin8, counts = _eb.hypergeom_band_hostchunks(
                    s_ind, nan0, nnn, lgt, M, thr, bt=bt, rank_np=rank,
                    attr_chunk=attr_chunk, precision=self.matmul_precision)
            else:
                self._hypergeom_engine_used = "loop-band"
                dev = self.device
                args = (plan["u"], plan["v"], plan["w"],
                        torch.as_tensor(nan0, device=dev),
                        torch.as_tensor(nnn, device=dev),
                        torch.as_tensor(K, device=dev), lgt, M, radius, thr,
                        plan["rank_dev"])
                kw = dict(n=num_nodes, band=band, iterations=iters,
                          keep_distances=bool(self.keep_node_distances),
                          precision=self.matmul_precision,
                          packed=self._band_bits_selected(num_nodes, band))
                bf = self._band_bf_args(plan)
                out = _pipe.fused_hypergeom_pipeline_band(*args, **kw, **bf)
                if bf and not out[7]:
                    self._band_relax_used = "bf->fw"
                    logging.info("band BF relax hit its iteration budget; "
                                 "re-dispatching Floyd-Warshall")
                    del out
                    out = _pipe.fused_hypergeom_pipeline_band(*args, **kw)
                else:
                    self._band_relax_used = "bf" if bf else "fw"
                (dist_band, s_ind, log_sf32, nesbin8, counts, mean,
                 std) = out[:7]
        self.apsp_engine_used, self.window_used = "band-storage", None
        self._store_hypergeom_results(None, log_sf32, nesbin8, counts)
        self._store_band_neighborhoods(s_ind, dist_band, rank, band, mean,
                                       std)
        self._update_binary_enrichment()

    def _hypergeom_bandstore(self, bm, n2a):
        """The staged hypergeometric test over band-stored neighborhoods
        (``safe.py:1327-1390``): the class table
        (``table-band-staged``), else the tail loop in host chunks
        (``hostchunks-band-staged``) or whole (``loop-band-staged``), the
        rows un-permuted on the device. ``hypergeom_engine='table'`` raises
        where the table does not apply."""
        order = np.argsort(bm.rank)  # permuted position -> original node
        thr = np.float64(self.enrichment_threshold)
        kw = dict(bt=bm.bt, block=bm.block, precision=self.matmul_precision)
        table_out = None
        if self.hypergeom_engine in ("auto", "table"):
            logsf_out = self._table_logsf_out()
            nan0, nnn, K, binary_ok, M = \
                self._band_hyper_operands_cached(order)
            if binary_ok:
                table_out = _eb.hypergeom_band_table(
                    bm.data, nan0, nnn, M, thr, rank_np=bm.rank,
                    logsf_out=logsf_out, K_np=K.cpu().numpy(), **kw)
        if table_out is not None:
            self._hypergeom_engine_used = "table-band-staged"
            return self._store_hypergeom_results(None, *table_out)
        if self.hypergeom_engine == "table":
            raise ValueError(
                "hypergeom_engine='table' requires binary 0/1 annotations "
                "with an in-budget class table")

        nan0, nnn, K, M, iters, lgt = self._band_tail_operands(n2a, order)
        attr_chunk = self._hypergeom_attr_chunk(bm.n, n2a.shape[1])
        if attr_chunk is not None:
            self._hypergeom_engine_used = "hostchunks-band-staged"
            log_sf32, nes_binary8, counts = _eb.hypergeom_band_hostchunks(
                bm.data, nan0, nnn, lgt, M, thr, rank_np=bm.rank,
                attr_chunk=attr_chunk, **kw)
        else:
            self._hypergeom_engine_used = "loop-band-staged"
            dev = self.device
            log_sf32, nes_binary8 = _eb.hypergeom_core_band(
                bm.data, torch.as_tensor(nan0, device=dev),
                torch.as_tensor(nnn, device=dev),
                torch.as_tensor(K, device=dev), lgt, M, thr,
                iterations=iters,
                rank=torch.as_tensor(bm.rank, device=dev), **kw)
            counts = nes_binary8.sum(dim=0, dtype=torch.int32)
        self._store_hypergeom_results(None, log_sf32, nes_binary8, counts)

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
                self._nes_binary_csc = _dd.indicator_csc(self._nes_binary_dev,
                                                         counts)
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
        edges = (self._graph_arrays[1] if self.graph_euclidean is None
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
        if (self._domains_inter_cache is None
                and self._nes_binary_dev is not None
                and self.attribute_distance_metric == "jaccard"
                and _domains.uses_gemm(self.cluster_engine, "jaccard",
                                       int(np.sum(self.attributes["top"])))):
            self._domains_inter_cache = _dd.enrichment_intersections(
                self._nes_binary_dev)
        self.attributes, self.node2domain = _domains.define_domains(
            self.attributes, lambda: self.nes, self._nes_binary_small,
            distance_metric=self.attribute_distance_metric,
            distance_threshold=self.attribute_distance_threshold,
            verbose=self.verbose, cluster_engine=self.cluster_engine,
            intersections=self._domains_inter_cache,
            nes_binary_dev=self._nes_binary_dev, nes_dev=self._nes_device(),
            device=self.device)

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

    # ---------------------------------------------------------------- output

    def print_output_files(self, **kwargs):
        """The three TSV reports into ``output_dir`` (``safe.py:2309``,
        ``output.py``)."""
        _output.print_output_files(self, **kwargs)
