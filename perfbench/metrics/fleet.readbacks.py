"""The device-to-host copies a record (the trace's ``DtoH`` memcpys in the
window, summed over the cards, over its records): in ``sample_fleet`` each
step's kernel-seed readback and the record's columns, and a call's final
fields and stats."""


def read(ctx):
    if not ctx.records:
        return None
    copies = sum(1 for _, name, cat, _, _ in ctx.trace.device_ops
                 if cat == 'gpu_memcpy' and 'DtoH' in name)
    return copies / len(ctx.records) if copies else None
