"""enrichment.go_tail_iterations (iters/analysis, program span): the bodies
of the f64 hypergeometric tail loop run per analysis, the sum of the attr
``iterations`` of the ``enrichment.go_tail`` spans, from the profiled
sessions of device ops alone (``portbench.spans``). Each body follows one
wait of the host for the device (the loop's stopping test reads the largest
live term), so fewer is better. A count, which repeats exactly for the same
inputs. Nothing without tail spans or where one lacks the attr."""

from portbench import spans

TAIL = "enrichment.go_tail"


def iterations(recs):
    """The tail loop's bodies per analysis in ``recs``; None without
    analyses, without tail spans, or where one lacks ``iterations``."""
    runs = sum(1 for r in recs
               if r["name"] == spans.RUN and r["parent"] is None)
    tails = [r["attrs"] for r in recs if r["name"] == TAIL]
    if not runs or not tails or any("iterations" not in a for a in tails):
        return None
    return sum(a["iterations"] for a in tails) / runs


def read(ctx):
    recs = spans.records()
    return iterations(spans.device_records(recs)) if recs else None
