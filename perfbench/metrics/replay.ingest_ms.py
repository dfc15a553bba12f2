"""replay.ingest_ms: median of the benchmark's span around ingest_segment, ending in a synchronise."""


def read(run):
    if run.player != "selfplay":
        return None
    seconds = run.median_span("replay.ingest")
    return None if seconds is None else 1e3 * seconds
