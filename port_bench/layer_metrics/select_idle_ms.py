"""Device-idle milliseconds a phase that fall inside the port's
``select_programs`` spans, from the traced window: the idle gaps between
the clipped device operations (as ``device_idle`` finds them) met with
those spans. The rest of the idle time falls between phases, in the
benchmark's own loop."""

from port_bench.spans import per_phase_ms, select_idle_s


def read(ctx):
    s = select_idle_s(ctx)
    return None if s is None else per_phase_ms(ctx, s)
