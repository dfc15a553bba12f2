"""search.root_graph_share.eval: root h/f calls served by a CUDA graph's replay over all root calls of the
traced deep evaluation, in %, from the program's counters (``search.root_graph_replays`` of ``search.root_calls``);
nothing where the program does not count its root calls."""

from perfbench.harness import spans


def read(run):
    if run.player != "deep_eval":
        return None
    counts = spans.traced_counts(run)
    calls = (counts or {}).get("search.root_calls")
    if not calls:
        return None
    return 100.0 * counts.get("search.root_graph_replays", 0) / calls
