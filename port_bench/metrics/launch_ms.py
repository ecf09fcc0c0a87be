"""Host milliseconds a tick spends launching its captured graph, the mean
over the window's ticks: the tracer's host span ``replay`` around
``graph.replay()`` in ``StepGraph.step`` (``run["spans"]``). A launch
blocks where the card's queue is full, so at the learning cells it holds
the wait for a busy card."""


def read(run):
    spans = run.get("spans")
    return spans["host_self_ms"].get("replay") if spans else None
