"""The program's own spans, as the per-layer metrics read them.

``safepy_tpu_torch.profiling`` records a span at each layer boundary of an
analysis while a ``torch.profiler`` session records: ``facade.*`` (the
analysis's roots and its waits on device results), ``neighborhoods.*`` (the
FW front and its relax) and ``enrichment.*`` (the null, each chunk's gather
and count). Two views of them are read here:

- the program's records (:func:`records`): host times and, on the card,
  stream times from CUDA events. The harness profiles three sessions of
  whole analyses, seconds apart (``harness.SPAN_AT``); the host and stream
  times are read from the sessions that record device ops alone
  (:func:`device_records`), told apart from the one that also records the
  host's ops by the gaps between sessions;
- the ``record_function`` ranges the spans leave in a host-ops session's
  profile (``trace.Span.host``), on the same clock as its device events
  (:func:`idle_by_layer`).

A program without spans (an older checkout) gives no records, and the
metrics read nothing.
"""

from __future__ import annotations

from portbench import trace

RUN = "facade.run_pipeline"
LAYERS = ("facade.", "neighborhoods.", "enrichment.")
# two profiled sessions lie further apart than this; the analyses of one
# session follow one another with no more than the harness's own step
GAP_NS = 10 ** 9


def records() -> list[dict]:
    """The program's closed span records, oldest first; [] where the
    program has no spans."""
    from safepy_tpu_torch import profiling

    read = getattr(profiling, "span_records", None)
    return read() if read is not None else []


def sessions(recs: list[dict], gap_ns: int = GAP_NS) -> list[list[dict]]:
    """``recs`` split into profiled sessions, in order: a root that starts
    more than ``gap_ns`` after the previous root ended starts a session."""
    roots = sorted((r for r in recs if r["parent"] is None),
                   key=lambda r: r["start_ns"])
    session_of, k, end = {}, -1, None
    for r in roots:
        if end is None or r["start_ns"] - end > gap_ns:
            k += 1
        session_of[r["id"]] = k
        end = r["end_ns"] if end is None else max(end, r["end_ns"])
    out = [[] for _ in range(k + 1)]
    for r in recs:
        if r["root"] in session_of:
            out[session_of[r["root"]]].append(r)
    return out


def device_records(recs: list[dict], span_at=None) -> list[dict]:
    """The records of the sessions that recorded device ops alone: where
    there are as many sessions as ``span_at`` (default
    ``harness.SPAN_AT``, (share, host ops) pairs) lists, those it profiles
    without the host's ops; otherwise every session's (a profile of host
    ops alone, as on the CPU, or sessions too close to tell apart)."""
    if span_at is None:
        from portbench.harness import SPAN_AT as span_at
    parts = sessions(recs)
    if len(parts) == len(span_at):
        parts = [p for p, (_, host) in zip(parts, span_at) if not host]
    return [r for p in parts for r in p]


def per_analysis(recs: list[dict], names, key: str | None):
    """The sum of ``key`` (with None, of 1: a count) over the records named
    in ``names``, per analysis (a ``facade.run_pipeline`` root); None
    without analyses, without such records, or where a record lacks the
    value (no stream time on the CPU)."""
    runs = sum(1 for r in recs if r["name"] == RUN and r["parent"] is None)
    vals = [1 if key is None else r[key] for r in recs if r["name"] in names]
    if not runs or not vals or any(v is None for v in vals):
        return None
    return sum(vals) / runs


def read(names, key: str | None):
    """:func:`per_analysis` over the device-only sessions' records."""
    recs = records()
    return per_analysis(device_records(recs), names, key) if recs else None


def _idle(lo: float, hi: float, busy: list) -> list:
    """The gaps of [lo, hi] that the sorted ``busy`` intervals leave."""
    gaps, reach = [], lo
    for s, e in busy:
        if e <= reach:
            continue
        if s >= hi:
            break
        if s > reach:
            gaps.append((reach, s))
        reach = max(reach, e)
    if hi > reach:
        gaps.append((reach, hi))
    return gaps


def _innermost(spans: list, t: float):
    """The name of the innermost of the (name, start, end) ``spans`` that
    holds ``t`` (of nested ranges, the latest to start), or None."""
    best = None
    for name, s, e in spans:
        if s <= t < e and (best is None or s >= best[1]):
            best = (name, s, e)
    return None if best is None else best[0]


def idle_by_layer(span) -> tuple[float, dict]:
    """(idle seconds, {layer prefix: idle seconds}) of one profiled session
    that recorded the host's ops: the device's idle time inside its
    analyses, and the part of it while the host's innermost program span
    belongs to each layer (``LAYERS``). Idle time outside every program
    span counts in the first number alone. (0.0, {}) where the session holds
    no program span."""
    marks = [(s, e) for name, s, e in span.host if name == trace.ANALYSIS]
    prog = [h for h in span.host if h[0].startswith(LAYERS)]
    if not marks or not prog:
        return 0.0, {}
    busy = sorted((s, e) for _, s, e in span.device)
    total, by_layer = 0.0, {p: 0.0 for p in LAYERS}
    for lo, hi in marks:
        inside = [h for h in prog if h[2] > lo and h[1] < hi]
        cuts = sorted({lo, hi} | {min(max(t, lo), hi)
                                  for h in inside for t in h[1:]})
        gaps = _idle(lo, hi, busy)
        total += sum(e - s for s, e in gaps)
        for a, b in zip(cuts, cuts[1:]):
            name = _innermost(inside, 0.5 * (a + b))
            if name is None:
                continue
            idle = sum(min(e, b) - max(s, a) for s, e in gaps
                       if e > a and s < b)
            by_layer[name[:name.index(".") + 1]] += idle
    return total, by_layer


def idle_share(host_spans, layer: str):
    """100 x the device's idle time while the host's innermost program span
    is of ``layer`` (a prefix of ``LAYERS``) over all its idle time inside
    the analyses of the host-ops sessions; None without program spans."""
    total = part = 0.0
    for span in host_spans:
        t, by = idle_by_layer(span)
        total += t
        part += by.get(layer, 0.0)
    return 100.0 * part / total if total > 0 else None
