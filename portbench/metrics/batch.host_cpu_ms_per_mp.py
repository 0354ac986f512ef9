"""CPU milliseconds the whole process spent per decoded megapixel over the
window (``os.times``: user and system, every thread): the host's cost of
the batch entry, ``parallel.sharded.decode_batch_sharded``."""


def read(ctx):
    mp = ctx.megapixels
    return ctx.cpu_s * 1e3 / mp if mp > 0 else None
