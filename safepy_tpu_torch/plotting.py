"""Plots: the base network, the composite domain landscapes and the attribute
maps.

Port of ``safepy_tpu/plotting.py`` (reference ``safepy/safe.py:747-1265``,
``safe_io.py:433-690``): the same entry points, figure layouts and visual
constants, in matplotlib on the host, over the port's objects:

- the network is an :class:`~safepy_tpu_torch.io.NetworkRecord` (a
  networkx graph with nodes 0..N-1 also serves): coordinates from its
  ``x`` / ``y`` columns, edges in ``Graph.edges()`` order, node labels from
  its ``label`` column;
- the session's ``attributes`` is a dict of columns, ``node2domain`` a
  :class:`~safepy_tpu_torch.domains.NodeDomains` and ``domains`` a dict
  (``id``, ``label``; ``rgba`` once a composite plot has colored them);
- the per-attribute panels read one NES or indicator column at a time
  (``SAFE._nes_column`` / ``_nes_binary_column``), never the (N, A) matrix.

``plot_network`` draws what ``networkx.draw`` draws there (a scatter of the
nodes over a ``LineCollection`` of the edges, z-orders 2 and 1, the data
limits padded by 5% of the edges' extent, the axis off, the figure's face
white), without networkx. JAX's deliberate differences from the reference
carry over: seedable edge sampling and domain colors, the per-domain
contour indexing fix, and the NES-scaled alpha of the per-domain panels.

matplotlib is imported with this module, which the facade imports on the
first plot; the card's machine has none, so a session saved there is
plotted where matplotlib is (``SAFE.save``). The numbers the plots show
(node colors, edges, selections) come from :mod:`.plot_data`, which
imports no matplotlib. Outside Jupyter the backend
is Agg, as the JAX facade sets it (``safe.py:26-29``).
"""

from __future__ import annotations

import logging
import os
import random
import sys
import textwrap

if "matplotlib" not in sys.modules:
    import matplotlib
    matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
from matplotlib.collections import LineCollection  # noqa: E402
from matplotlib.colors import LinearSegmentedColormap  # noqa: E402
from scipy.optimize import fmin  # noqa: E402
from scipy.spatial import ConvexHull  # noqa: E402
from scipy.stats import gaussian_kde  # noqa: E402

from safepy_tpu_torch.colormaps import (MidpointRangeNormalize,  # noqa: E402
                                        get_colors)
from safepy_tpu_torch.io.graph_arrays import get_node_coordinates  # noqa: E402
from safepy_tpu_torch.io.table import read_table  # noqa: E402
from safepy_tpu_torch.io.xlsx import read_xlsx  # noqa: E402
from safepy_tpu_torch.plot_data import (domain_mixture_colors,  # noqa: E402
                                        domain_row, edge_index, isna,
                                        node_labels, select_attributes)

# JAX's names (plotting.py:334, :471)
_domain_mixture_colors = domain_mixture_colors
_select_attributes = select_attributes

# --------------------------------------------------------------------- style


class Style:
    """Foreground/background pairing plus the shared text and legend styling
    (``plotting.py:46-82``): a white background flips the foreground to
    black."""

    def __init__(self, foreground="#ffffff", background="#000000"):
        self.background = background
        self.foreground = "#000000" if background == "#ffffff" else foreground

    def node_label_font(self, size=14):
        color = "white" if self.background == "#000000" else "k"
        return {"color": color, "size": size, "weight": "bold"}

    def title_font(self, size=16):
        return {"size": size, "color": self.foreground, "weight": "bold"}

    def legend(self, ax, handles, labels, title, loc="upper left"):
        leg = ax.legend(handles, labels, loc=loc, bbox_to_anchor=(0, 1),
                        title=title, scatterpoints=1, fancybox=False,
                        facecolor=self.background, edgecolor=self.background)
        for text in leg.get_texts():
            text.set_color(self.foreground)
        leg.get_title().set_color(self.foreground)
        return leg

    def finish_panel(self, ax, title=None, invert_y=False):
        ax.set_aspect("equal")
        ax.set_facecolor(self.background)
        ax.grid(False)
        ax.margins(0.1, 0.1)
        if invert_y:
            ax.invert_yaxis()
        if title is not None:
            ax.set_title(title, color=self.foreground)


def _panel_grid(num_panels, style, panel_size=10):
    """Two-column grid of square panels with shared axes."""
    nrows = int(np.ceil(num_panels / 2))
    ncols = min(num_panels, 2)
    fig, axes = plt.subplots(nrows=nrows, ncols=ncols,
                             figsize=(panel_size * ncols, panel_size * nrows),
                             sharex=True, sharey=True,
                             facecolor=style.background)
    return fig, np.atleast_1d(np.asarray(axes)).ravel()


def _save_figure(fig, save_fig, style, output_dir=""):
    if not save_fig:
        return
    path = save_fig
    if output_dir and not os.path.isabs(path):
        path = os.path.join(output_dir, path)
    logging.info("Output path: %s" % path)
    fig.savefig(path, facecolor=style.background)


# ------------------------------------------------------------------ renderers


def _kde_isoline(ax, points, bounds, color, level=1e-6, grid_points=100):
    """Gaussian-KDE density isoline of a point cloud (``plotting.py:110``)."""
    kernel = gaussian_kde(points.T)
    (x_lo, x_hi), (y_lo, y_hi) = bounds
    grid_x, grid_y = np.mgrid[x_lo:x_hi:complex(0, grid_points),
                              y_lo:y_hi:complex(0, grid_points)]
    density = kernel(np.vstack([grid_x.ravel(), grid_y.ravel()]))
    return ax.contour(grid_x, grid_y, density.reshape(grid_x.shape), [level],
                      colors=[tuple(color)] if color is not None else None,
                      alpha=1)


def _label_isoline(contour_set, number, name):
    contour_set.levels = [number]
    plt.clabel(contour_set, contour_set.levels, inline=True, fmt="%d",
               fontsize=16)
    logging.info("%d -- %s" % (number, name))


def _hex_to_rgb(hex_color):
    digits = hex_color.lstrip("#")
    return tuple(int(digits[i:i + 2], 16) / 255 for i in (0, 2, 4))


def _diverging_enrichment_cmap(low_hex, high_hex, style):
    """Two accent colors fading through the background at the center."""
    anchors = [low_hex, style.background, style.background, style.background,
               high_hex]
    return LinearSegmentedColormap.from_list(
        "enrichment", [_hex_to_rgb(c) for c in anchors])


def _log_p_colorbar(fig, ax, scatter, style, vmin, midrange, vmax):
    """Horizontal colorbar with 10^x tick labels under the panel
    (``plotting.py:144-166``)."""
    box = ax.get_position()
    width = box.width * 0.75
    cax = fig.add_axes([box.x0 + (box.width - width) / 2, box.y0,
                        width, box.height * 0.05])
    bar = plt.colorbar(scatter, cax=cax, orientation="horizontal",
                       ticks=[vmin, *midrange, vmax], drawedges=False)
    bar.set_label("Neighborhood enrichment p-value", color=style.foreground)
    cax.xaxis.set_tick_params(color=style.foreground)
    bar.outline.set_edgecolor(style.foreground)
    bar.outline.set_linewidth(1)
    plt.setp(plt.getp(bar.ax.axes, "xticklabels"), color=style.foreground)
    bar.ax.set_xticklabels(
        [r"$10^{%d}$" % vmin, r"$10^{%d}$" % midrange[0], r"$1$",
         r"$10^{%d}$" % -midrange[2], r"$10^{-%d}$" % vmax])
    for x, side, align in ((cax.get_xlim()[0], "Lower than random", "left"),
                           (cax.get_xlim()[1], "Higher than random",
                            "right")):
        cax.text(x, 1, side, verticalalignment="bottom",
                 horizontalalignment=align,
                 fontdict={"color": style.foreground})
    return bar


# ------------------------------------------------------------- base network


def _draw_network(ax, node_xy, edges, color, node_size, alpha):
    """What ``nx.draw(G, pos, edgelist=edges, node_color=color,
    edge_color=color, node_size=node_size, width=1, alpha=alpha)`` draws
    (networkx 3.x ``draw_networkx_nodes`` / ``_edges``): the nodes' scatter,
    then the edges' LineCollection behind them, the view padded to the
    edges, ticks and axis off, the figure's face white."""
    ax.get_figure().set_facecolor("w")
    nodes = ax.scatter(node_xy[:, 0], node_xy[:, 1], s=node_size, c=color,
                       marker="o", alpha=alpha)
    ax.tick_params(axis="both", which="both", bottom=False, left=False,
                   labelbottom=False, labelleft=False)
    nodes.set_zorder(2)
    if len(edges):
        segments = node_xy[edges]  # (E, 2 ends, 2)
        lines = LineCollection(segments, colors=color, linewidths=1,
                               antialiaseds=(1,), linestyle="solid",
                               alpha=alpha)
        lines.set_zorder(1)
        ax.add_collection(lines)
        lo = segments.reshape(-1, 2).min(axis=0)
        hi = segments.reshape(-1, 2).max(axis=0)
        pad = 0.05 * (hi - lo)
        ax.update_datalim(((lo[0] - pad[0], lo[1] - pad[1]),
                           (hi[0] + pad[0], hi[1] + pad[1])))
        ax.autoscale_view()
    ax.set_axis_off()


def plot_network(G, ax=None, foreground_color="#ffffff",
                 background_color="#000000", random_sampling_edges_min=30000,
                 title="Network", node_size=10, alpha=0.2, seed=None):
    """Base scatter and edge rendering of the network
    (``plotting.py:171-197``): from ``random_sampling_edges_min`` edges, a
    tenth of them drawn by ``random.Random(seed).sample``, the positions
    JAX's sample takes from its tuple of ``G.edges()``."""
    style = Style(foreground_color, background_color)
    node_xy = get_node_coordinates(G)

    if ax is None:
        fig, ax = plt.subplots(figsize=(20, 10), facecolor=style.background,
                               edgecolor=style.foreground)
        fig.set_facecolor(style.background)

    edges = edge_index(G)
    if len(edges) >= random_sampling_edges_min:
        logging.warning(
            "Edges are randomly sampled because the network (edges=%d) is "
            "too big (random_sampling_edges_min=%d)."
            % (len(edges), random_sampling_edges_min))
        edges = edges[random.Random(seed).sample(range(len(edges)),
                                                 int(len(edges) * 0.1))]

    _draw_network(ax, node_xy, edges, style.foreground, node_size, alpha)
    style.finish_panel(ax, title=title, invert_y=True)
    plt.axis("off")
    return ax


def plot_network_contour(graph, ax, background_color="#000000"):
    """Least-squares circle through the layout's convex hull
    (``plotting.py:200-220``)."""
    style = Style(background=background_color)

    node_xy = get_node_coordinates(graph)
    hull = ConvexHull(node_xy)
    hull_x = node_xy[hull.vertices, 0]
    hull_y = node_xy[hull.vertices, 1]

    center_x, center_y = np.nanmean(hull_x), np.nanmean(hull_y)
    radius0 = np.nanmean(np.hypot(hull_x - center_x, hull_y - center_y))

    def residual(params):
        cx, cy, r = params
        return ((np.hypot(hull_x - cx, hull_y - cy) - r) ** 2).sum()

    fit_x, fit_y, fit_r = fmin(residual, [center_x, center_y, radius0],
                               disp=False)

    ax.add_patch(plt.Circle((fit_x, fit_y), radius=fit_r * 1.01,
                            color=style.foreground, linewidth=1, fill=False))
    return fit_x, fit_y, fit_r


def _read_costanzo_clusters(path_to_data):
    """The published cluster-identity table (``plotting.py:223-239``): the
    .xlsx that safe-data ships, through :func:`~.io.xlsx.read_xlsx`, else
    a same-schema .tsv beside it."""
    base = os.path.join(
        path_to_data, "other/Data File S5_SAFE analysis_Gene cluster "
                      "identity and functional enrichments")
    if os.path.exists(base + ".xlsx"):
        return read_xlsx(base + ".xlsx",
                         sheet_name="Global net. cluster gene list")
    return read_table(base + ".tsv")


def plot_costanzo2016_network_annotations(graph, ax, path_to_data,
                                          colors=True, clabels=False,
                                          foreground_color="#ffffff",
                                          background_color="#000000"):
    """Published process-region KDE contours from the safe-data bundle
    (``plotting.py:242-274``)."""
    style = Style(foreground_color, background_color)

    clusters = _read_costanzo_clusters(path_to_data)
    regions = clusters["Global Similarity Network Region name"]
    genes = clusters["Gene/Allele"]
    processes = list(dict.fromkeys(r for r in regions if not isna(r)))

    color_table = read_table(
        os.path.join(path_to_data, "other/costanzo_2016_colors.txt"))
    if colors:
        process_colors = np.column_stack(
            [color_table[c] for c in ("R", "G", "B")]) / 256
    else:
        fill = 1.0 if style.foreground == "#ffffff" else 0.0
        process_colors = np.full((len(color_table["R"]), 3), fill)

    label2node = node_labels(graph)
    node_xy = get_node_coordinates(graph)
    bounds = ((node_xy[:, 0].min(), node_xy[:, 0].max()),
              (node_xy[:, 1].min(), node_xy[:, 1].max()))

    for number, process in enumerate(processes):
        members = [label2node[g] for r, g in zip(regions, genes)
                   if r == process and g in label2node]
        isoline = _kde_isoline(ax, node_xy[members, :], bounds,
                               process_colors[number, :])
        if clabels:
            _label_isoline(isoline, number + 1, process)


def mark_nodes(x, y, kind, ax=None, foreground_color="#ffffff",
               background_color="#000000", labels=None, label_va="center",
               legend_label=None, **kws):
    """Mark and/or text-label selected nodes (``plotting.py:277-299``)."""
    style = Style(foreground_color, background_color)
    if ax is None:
        ax = plt.gca()
    if isinstance(kind, str):
        kind = [kind]

    marks = None
    if "mark" in kind:
        marks = ax.scatter(x, y, **kws)

    if "label" in kind:
        assert len(x) == len(labels), \
            f"len(x)!=len(labels): {len(x)}!={len(labels)}"
        for xi, yi, label in zip(x, y, labels):
            ax.text(xi, yi, label, fontdict=style.node_label_font(),
                    ha="center", va=label_va)

    if legend_label is not None and marks is not None:
        style.legend(ax, [marks], [legend_label], title="Significance")
    return ax


def plot_safe_network(sf, foreground_color="#ffffff",
                      background_color="#000000", labels=(), node_size=10,
                      alpha=0.2, **kwargs_mark_nodes):
    """``SAFE.plot_network``: the base plot, plus labelled nodes
    (``plotting.py:302-310``)."""
    ax = plot_network(sf.graph, background_color=background_color,
                      node_size=node_size, alpha=alpha)
    if len(labels) > 0:
        _mark_labeled_nodes(sf.graph, labels, ax, foreground_color,
                            background_color, **kwargs_mark_nodes)
    return ax


def _mark_labeled_nodes(graph, labels, ax, foreground_color, background_color,
                        **kwargs):
    node_xy_labels, labels_found = get_node_coordinates(graph, labels=labels)
    return mark_nodes(node_xy_labels[:, 0], node_xy_labels[:, 1],
                      kind=["label"], labels=labels_found, ax=ax,
                      foreground_color=foreground_color,
                      background_color=background_color, **kwargs)


# ------------------------------------------------------- composite landscape


def _domain_colors(sf, seed=None):
    """The domains' colors, stored as the domains table's ``rgba`` column
    (``plotting.py:327-331``)."""
    domains = np.sort(np.unique(np.asarray(sf.attributes["domain"])))
    domain2rgb = get_colors("hsv", len(domains), seed=seed)
    sf.domains["rgba"] = domain2rgb[:len(sf.domains["id"])].tolist()
    return domains, domain2rgb


def plot_composite_network(sf, show_each_domain=False, show_domain_ids=True,
                           show_network_contour=True, save_fig=None,
                           labels=(), foreground_color="#ffffff",
                           background_color="#000000", color_seed=None):
    """All nodes colored by their domain mixtures (``plotting.py:369-410``)."""
    style = Style(foreground_color, background_color)
    domains, domain2rgb = _domain_colors(sf, seed=color_seed)
    node_colors = _domain_mixture_colors(sf, domain2rgb)
    node_xy = get_node_coordinates(sf.graph)

    num_panels = 2 + (len(domains) - 1 if show_each_domain else 0)
    fig, axes = _panel_grid(num_panels, style)

    plot_network(sf.graph, ax=axes[0], background_color=style.background)

    dimmest_first = np.argsort(np.sum(node_colors, axis=1))
    axes[1].scatter(node_xy[dimmest_first, 0], node_xy[dimmest_first, 1],
                    c=node_colors[dimmest_first], s=60, edgecolor=None)
    style.finish_panel(axes[1])

    if show_network_contour:
        plot_network_contour(sf.graph, axes[1],
                             background_color=style.background)

    if len(labels) != 0:
        _mark_labeled_nodes(sf.graph, labels, axes[1], style.foreground,
                            style.background)

    primary = np.asarray(sf.node2domain["primary_domain"])
    if show_domain_ids:
        for domain in domains[domains > 0]:
            members = primary == domain
            axes[1].text(np.nanmean(node_xy[members, 0]),
                         np.nanmean(node_xy[members, 1]), str(domain),
                         fontdict=style.title_font())

    if show_each_domain:
        for domain in domains[domains > 0]:
            _plot_single_domain(sf, axes[1 + domain], domain,
                                domain2rgb[domain], node_xy, style,
                                show_network_contour, labels)

    fig.set_facecolor(style.background)
    _save_figure(fig, save_fig, style)
    return fig, axes


def _plot_single_domain(sf, ax, domain, rgba, node_xy, style,
                        show_network_contour, labels):
    """One per-domain panel: its primary nodes in the domain's color, alpha
    the NES over ``enrichment_max_log10`` in [0.2, 1]
    (``plotting.py:413-432``)."""
    members = np.asarray(sf.node2domain["primary_domain"]) == domain
    alpha = np.asarray(sf.node2domain["primary_nes"]) \
        / sf.enrichment_max_log10
    alpha = np.clip(alpha, 0.2, 1.0)

    colors = np.tile(np.asarray(rgba, dtype=float), (int(members.sum()), 1))
    colors[:, 3] = alpha[members]
    ax.scatter(node_xy[members, 0], node_xy[members, 1], c=colors, s=60,
               edgecolor=None)
    label = sf.domains["label"][domain_row(sf.domains, domain)]
    style.finish_panel(ax, title="Domain %d\n%s" % (domain, label))
    if show_network_contour:
        plot_network_contour(sf.graph, ax, background_color=style.background)
    if len(labels) != 0:
        _mark_labeled_nodes(sf.graph, labels, ax, style.foreground,
                            style.background)


def plot_composite_network_contours(sf, save_fig=None, clabels=False,
                                    background_color="#000000",
                                    color_seed=None):
    """KDE contour per domain over the base network
    (``plotting.py:435-468``)."""
    style = Style(background=background_color)
    _domain_colors(sf, seed=color_seed)
    node_xy = get_node_coordinates(sf.graph)

    fig, axes = _panel_grid(2, style)
    plot_network(sf.graph, ax=axes[0], background_color=style.background)
    style.finish_panel(axes[1])

    n2d = sf.node2domain
    for number, domain_label in enumerate(sf.domains["label"]):
        if number not in n2d.domains:
            continue
        members = np.flatnonzero(n2d[number] > 0)
        if len(members) < 3:
            continue
        points = node_xy[members, :]
        bounds = ((points[:, 0].min(), points[:, 0].max()),
                  (points[:, 1].min(), points[:, 1].max()))
        color = (sf.domains["rgba"][domain_row(sf.domains, number)]
                 if "rgba" in sf.domains else None)
        isoline = _kde_isoline(axes[1], points, bounds, color)
        if clabels:
            _label_isoline(isoline, number + 1, domain_label)

    fig.set_facecolor(style.background)
    _save_figure(fig, save_fig, style)
    return fig, axes


# ------------------------------------------------------- attribute landscape


def plot_sample_attributes(sf, attributes=1, top_attributes_only=False,
                           show_network=True, show_network_contour=True,
                           show_costanzo2016=False,
                           show_costanzo2016_colors=True,
                           show_costanzo2016_clabels=False, show_nes=True,
                           show_raw_data=False, show_significant_nodes=False,
                           show_colorbar=True, colors=("82add6", "facb66"),
                           foreground_color="#ffffff",
                           background_color="#000000", labels=(),
                           save_fig=None, seed=None, **kwargs):
    """Per-attribute enrichment landscapes (``plotting.py:492-572``)."""
    style = Style(foreground_color, background_color)
    chosen = _select_attributes(sf, attributes, top_attributes_only, seed)
    node_xy = get_node_coordinates(sf.graph)
    names = list(sf.attributes["name"])

    base_panels = 1 if show_network else 0
    fig, axes = _panel_grid(len(chosen) + base_panels, style)

    if show_network:
        plot_network(sf.graph, ax=axes[0], background_color=style.background)

    for panel, attribute in enumerate(chosen):
        ax = axes[panel + base_panels]
        scatter = None
        vmin = vmax = None
        midrange = kwargs.get("midrange",
                              [np.log10(0.05), 0, -np.log10(0.05)])

        if show_nes:
            nes_column = sf._nes_column(attribute)
            vmin = kwargs.get("vmin", np.nanmin(
                [np.log10(1 / sf.num_permutations),
                 np.nanmin(-np.abs(nes_column))]))
            vmax = kwargs.get("vmax", np.nanmax(
                [-np.log10(1 / sf.num_permutations),
                 np.nanmax(np.abs(nes_column))]))
            strongest_last = np.argsort(np.abs(nes_column))
            cmap = _diverging_enrichment_cmap(
                "#" + colors[0].lstrip("#"), "#" + colors[1].lstrip("#"),
                style)
            scatter = ax.scatter(
                node_xy[strongest_last, 0], node_xy[strongest_last, 1],
                c=nes_column[strongest_last], s=60, cmap=cmap,
                norm=MidpointRangeNormalize(midrange=midrange,
                                            vmin=vmin, vmax=vmax),
                edgecolors=None)

        if show_colorbar and scatter is not None:
            _log_p_colorbar(fig, ax, scatter, style, vmin, midrange, vmax)

        if show_raw_data:
            _plot_raw_data(sf, ax, attribute, node_xy, style)

        if show_significant_nodes:
            significant = sf._nes_binary_column(attribute) > 0
            mark_nodes(node_xy[significant, 0], node_xy[significant, 1],
                       kind=["mark"], ax=ax,
                       legend_label="p < %.2e" % sf.enrichment_threshold,
                       foreground_color=style.foreground,
                       background_color=style.background, marker="+")

        if show_costanzo2016:
            plot_costanzo2016_network_annotations(
                sf.graph, ax, sf.path_to_safe_data,
                colors=show_costanzo2016_colors,
                clabels=show_costanzo2016_clabels,
                background_color=style.background)

        if show_network_contour:
            plot_network_contour(sf.graph, ax,
                                 background_color=style.background)

        if len(labels) != 0:
            _mark_labeled_nodes(sf.graph, labels, ax, style.foreground,
                                style.background)

        title = "\n".join(textwrap.wrap(str(names[attribute]), width=30))
        style.finish_panel(ax, title=title,
                           invert_y=(panel + base_panels == 0))
        ax.set_frame_on(False)

    fig.set_facecolor(style.background)
    _save_figure(fig, save_fig, style, output_dir=sf.output_dir)
    return fig, axes


RAW_NEGATIVE_COLOR = "#ff1d23"
RAW_POSITIVE_COLOR = "#00ff44"
RAW_MARKER_SIZES = (5, 5, 55)  # zero, min, max (reference safe.py:1152-1154)


def _plot_raw_data(sf, ax, attribute, node_xy, style):
    """Size-scaled positive / negative raw-value markers with their legend
    (``plotting.py:580-612``)."""
    size_zero, size_min, size_max = RAW_MARKER_SIZES
    values = sf.node2attribute[:, attribute]
    magnitude = np.abs(values)

    finite = magnitude[~np.isnan(magnitude)]
    if set(np.unique(finite)).issubset([0, 1]):
        sizes = np.where(magnitude > 0, size_max, 0.0)
        value_min, value_max = 0, 1
    else:
        value_min, value_max = np.nanpercentile(np.unique(magnitude), [5, 95])
        slope = (size_max - size_min) / (value_max - value_min)
        sizes = np.clip(slope * (magnitude - value_min) + size_min,
                        size_min, size_max)

    with np.errstate(invalid="ignore"):
        groups = ((values < 0, RAW_NEGATIVE_COLOR, None),
                  (values > 0, RAW_POSITIVE_COLOR, None),
                  (values == 0, style.foreground, size_zero))
    for selector, color, fixed_size in groups:
        ax.scatter(node_xy[selector, 0], node_xy[selector, 1],
                   s=sizes[selector] if fixed_size is None else fixed_size,
                   c=color, marker=".")

    swatches = [(size_max, RAW_POSITIVE_COLOR), (size_min, RAW_POSITIVE_COLOR),
                (size_zero, style.foreground), (size_min, RAW_NEGATIVE_COLOR),
                (size_max, RAW_NEGATIVE_COLOR)]
    handles = [plt.scatter([], [], s=s, c=c, edgecolors="none")
               for s, c in swatches]
    legend_values = [value_max, value_min, 0, -value_min, -value_max]
    style.legend(ax, handles, ["{0:.2f}".format(v) for v in legend_values],
                 title="Raw data")
