"""kernels.logsf_table_roofline_pct (%, device trace): the least time the
class tables of an analysis need on the card, their f32 bytes written once
(4 x R x S_max x C of each ``enrichment.go_table`` span's attrs, per
analysis of the profiled sessions of device ops alone) over 3.35 TB/s, as
a share of the device time per analysis of the ``csrc/hypergeom_table.cu``
kernel (``logsf_table_kernel``, matched by name) in a profiled span. Of
the three spans, the one with the most kernel time (a dropped profiler
event only lowers a reading). Nothing where no span shows the kernel (a
program that builds the table otherwise) or no table span gives its
geometry."""

from portbench import spans, work

KERNEL = "logsf_table_kernel"
TABLE = "enrichment.go_table"


def table_bytes(recs):
    """The class tables' f32 bytes per analysis in ``recs``; None without
    analyses, without table spans, or where one lacks R, S_max or C."""
    runs = sum(1 for r in recs
               if r["name"] == spans.RUN and r["parent"] is None)
    tables = [r["attrs"] for r in recs if r["name"] == TABLE]
    if not runs or not tables or any(
            k not in a for a in tables for k in ("R", "S_max", "C")):
        return None
    return sum(4 * a["R"] * a["S_max"] * a["C"] for a in tables) / runs


def roofline(kernel_spans, recs):
    """100 x the tables' bytes at the HBM peak over the kernel's device
    time, both per analysis; None where either is missing."""
    per = [s.device_s(lambda name: KERNEL in name) / s.analyses
           for s in kernel_spans if s.analyses]
    nbytes = table_bytes(recs)
    if nbytes is None or not per or max(per) <= 0:
        return None
    return 100.0 * nbytes / work.HBM_BYTES_PER_S / max(per)


def read(ctx):
    recs = spans.records()
    return roofline(ctx.spans, spans.device_records(recs)) if recs else None
