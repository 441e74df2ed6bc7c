"""Mean host ms of a batch's ranking: the program's ``server.rank`` spans
(``eval/instseg_eval.rank_instances`` of each real request at full point
resolution) in the device-only traced window's session
(``perfbench/spans.py``)."""
from perfbench.spans import named, window_spans


def read(ctx):
    ws = window_spans(ctx)
    ms = [1e3 * (s["end"] - s["start"]) for s in named(ws, "server.rank")] \
        if ws else []
    return sum(ms) / len(ms) if ms else None
