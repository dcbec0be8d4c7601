"""Host milliseconds a phase inside the port's ``select_programs`` span
but outside its ``select.sync`` spans, from the traced window: the
port's own Python and enqueue work in selection, without the waits at
its host syncs (``select_sync_wait_ms``; the two add up to the mean
``select_programs`` span)."""

from port_bench.spans import per_phase_ms, select_split


def read(ctx):
    split = select_split(ctx)
    return None if split is None else per_phase_ms(ctx, split[0])
