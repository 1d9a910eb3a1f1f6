"""The port's own spans and counters (vtaco_tpu_torch/utils/profiling.py)
as the traced run's readers take them: per request or per step of the
profiled block, which is all the store holds after a traced run (the
program records only while the profiler does). Each reader returns None
for another family's record and where the port keeps no such store."""


def store():
    """The port's tracer module, or None where it keeps no spans."""
    try:
        from vtaco_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "records") else None


def units(record, family):
    """The profiled block's requests (grasp) or steps (train), or None."""
    if record.get("family") != family:
        return None
    n = len(record.get("profiled") or ()) if family == "grasp" else record.get("profiled_steps")
    return n or None


def span_ms(record, family, name):
    """The host ms of the spans ``name`` per request or step."""
    prof, n = store(), units(record, family)
    if prof is None or n is None:
        return None
    ns = [r.end - r.start for r in prof.records() if r.name == name]
    return sum(ns) / 1e6 / n if ns else None


def counter(record, family, name):
    """The counter ``name`` per request or step (0 where it never
    counted, once the program kept spans)."""
    prof, n = store(), units(record, family)
    if prof is None or n is None or not prof.records():
        return None
    return prof.counters().get(name, 0) / n
