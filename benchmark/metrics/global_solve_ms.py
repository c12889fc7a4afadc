"""global_solve_ms: device milliseconds per chunk of the kernels launched under the
port's ``global_solve`` stage span (its CUDA graph's replay), over the traced
slice's chunks (one ``chunk_local`` span each)."""


def read(ctx):
    t = ctx.trace
    chunks = t["span_counts"].get("chunk_local", 0) if t else 0
    ms = t["device_ms_by_op_all"].get("global_solve", 0.0) if t else 0.0
    return ms / chunks if chunks and ms > 0 else None
