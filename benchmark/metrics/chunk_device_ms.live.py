"""chunk_device_ms.live: device milliseconds per chunk over the traced
slice: every kernel whose launch the slice holds, over its chunks (one
``chunk_local`` span each). Kernels of an earlier chunk still running when
the slice starts are left out (their launches were not traced)."""


def read(ctx):
    t = ctx.trace
    chunks = t["span_counts"].get("chunk_local", 0) if t else 0
    if not chunks:
        return None
    ms = sum(v for op, v in t["device_ms_by_op_all"].items() if op != "(launch not traced)")
    return ms / chunks if ms > 0 else None
