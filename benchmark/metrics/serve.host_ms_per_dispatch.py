"""Host seconds a dispatch spends packing and enqueueing its fleet and
fetching and unstacking its results (``pack_s`` + ``fetch_s`` of the
service's dispatch records, from ``FleetService.stats()`` before and
after the window)."""


def read(ctx):
    rec = ctx["record"]
    if not rec.get("dispatches"):
        return None
    return rec["host_s"] / rec["dispatches"] * 1e3
