"""Share of the quiet window's decode batches whose layer loop ran as a
replayed CUDA graph, in percent: the engine's decode_graph_replays over its
decode_batches (EngineStats deltas). None where the program does not count
replays (a program without decode graphs)."""
from cardbench.lib import window


def read(run):
    st = window.quiet_steps(run)
    replays = [s.stats.get("decode_graph_replays") for s in st]
    batches = sum(s.stats["decode_batches"] for s in st)
    if None in replays or not batches:
        return None
    return 100.0 * sum(replays) / batches
