"""Host syncs a phase of ``select_programs``: the port's counter
``select_programs.host_syncs`` (one per sync site passed) over every
phase the process ran, the set-up's, the measured window's and the
traced window's; None where the port has no such counter."""

from vae_extent_search_tpu_torch.search import select


def read(ctx):
    syncs = getattr(select.select_programs, "host_syncs", None)
    if syncs is None:
        return None
    phases = (int(ctx["traffic"]["warmup_phases"]) + len(ctx["timed"])
              + ctx["phases"])
    return syncs / phases
