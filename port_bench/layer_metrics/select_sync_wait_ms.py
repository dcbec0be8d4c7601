"""Host milliseconds a phase inside the port's ``select.sync`` spans
within ``select_programs``, from the traced window: the host's waits for
the card at each place where selection reads a device value on the host
(the kernel's seed draw, the k-center loop's 0-d indexing)."""

from port_bench.spans import per_phase_ms, select_split


def read(ctx):
    split = select_split(ctx)
    return None if split is None else per_phase_ms(ctx, split[1])
