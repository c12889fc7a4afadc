"""dense_live_pct: the share of the dense-pair list's slots that were live
in the global solve's dense term, 100 x the runlog's ``dense_pairs_live``
over the configuration's ``max_dense_pairs_global`` (every GN iteration
evaluates every slot), over the window's kept chunks (those of
``benchmark/timeline.py``). None without the term, or where the runlog has
no such counter."""


def kept_records(window) -> list[dict]:
    """The runlog records of the window's kept chunks that carry the dense
    term's counters."""
    return [r for s in window.scans for r in s["runlog"]
            if r.get("timeline") is not None and r["chunk"] > 0 and not r["timeline"]["profiled"]
            and not r["timeline"]["flush"] and "dense_pairs_live" in r]


def read(ctx):
    bc = ctx.config["bundling"]
    recs = kept_records(ctx.window)
    if not (bc.get("use_dense_global") and recs):
        return None
    return 100.0 * sum(r["dense_pairs_live"] for r in recs) / (len(recs) * bc["max_dense_pairs_global"])
