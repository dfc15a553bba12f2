"""search.kernel_tree_share.selfplay: the search kernel's computing warps' cycles spent in the traversal, the gather
and install of node embeddings, and the backup, over all their cycles, in the traced segment, in %, from the
clocked kernel's counters (``search.kernel.cycles.tree`` of ``search.kernel.cycles``); nothing where the program
does not clock its kernel."""

from perfbench.harness import spans


def read(run):
    if run.player != "selfplay":
        return None
    counts = spans.traced_counts(run)
    cycles = (counts or {}).get("search.kernel.cycles")
    if not cycles:
        return None
    return 100.0 * counts.get("search.kernel.cycles.tree", 0) / cycles
