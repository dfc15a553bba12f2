"""search.kernel_barrier_share.eval: the search kernel's computing warps' cycles spent waiting at the computing
threads' barriers, over all their cycles, in the traced deep evaluation, in %, from the clocked kernel's counters
(``search.kernel.cycles.barrier`` of ``search.kernel.cycles``); nothing where the program does not clock its
kernel."""

from perfbench.harness import spans


def read(run):
    if run.player != "deep_eval":
        return None
    counts = spans.traced_counts(run)
    cycles = (counts or {}).get("search.kernel.cycles")
    if not cycles:
        return None
    return 100.0 * counts.get("search.kernel.cycles.barrier", 0) / cycles
