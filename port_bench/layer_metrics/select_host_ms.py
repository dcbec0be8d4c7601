"""Host milliseconds from a phase's start until ``select_programs``
returns (before the fetch of its picks), the mean over the phases of the
unprofiled window, from the benchmark's own times around the call. It
holds the waits of the host at the syncs inside ``select_programs`` (the
draw of the kernel's seed), so it reads the host's share of a phase only
where the device is not the one waited for."""


def read(ctx):
    spans = [b - a for a, b, _ in ctx["timed"]]
    return 1e3 * sum(spans) / len(spans) if spans else None
