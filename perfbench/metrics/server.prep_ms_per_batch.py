"""Host milliseconds a batch in the server thread's pure host work: its
``preprocess`` and ``collate`` stage seconds (``ServerStats.stage_s``)
over the batches it ran."""


def read(ctx):
    stages, steps = ctx.get("stages"), ctx.get("steps")
    if not stages or not steps or "preprocess" not in stages:
        return None
    return (stages["preprocess"] + stages.get("collate", 0.0)) / steps * 1e3
