"""Device timing of kernel wrappers with CUDA events (needs a card).

:func:`cuda_ms` times calls issued one after another from Python: where a
wrapper's host work (checks, allocations, the ``ctypes`` call) takes longer
than its kernels, it measures the host.  :func:`graph_ms` captures the calls
in one CUDA graph and times its replay, so the card runs the launches back
to back: the kernels' own time.
"""

from __future__ import annotations

import torch


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn``, issued eagerly (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(fn, reps: int, replays: int = 3) -> float:
    """Mean device milliseconds per call of ``fn``: ``reps`` calls captured
    in one CUDA graph (outputs from the graph's own pool), replayed
    ``replays`` times after one untimed replay.  ``fn`` must launch on the
    current stream and never wait on the host."""
    fn()                                     # builds, opts in shared memory
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / (replays * reps)
    del graph
    torch.cuda.empty_cache()
    return ms
