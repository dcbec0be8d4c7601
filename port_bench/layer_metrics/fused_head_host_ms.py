"""Host milliseconds a phase inside the port's ``fused_head.launch``
span, from the traced window: the weight casts and transposes, the bias
concatenation, the launch plan and the library call before the fused
head's kernel is queued. The seed draw's sync has just drained the
queue, so the card waits through all of it."""

from port_bench.spans import LAUNCH, host_spans, per_phase_ms
from port_bench.trace import union_length


def read(ctx):
    spans = host_spans(ctx["trace"], LAUNCH)
    return per_phase_ms(ctx, union_length(spans)) if spans else None
