"""mc_ms.grasp: the mean over the window's requests of the host time of
marching cubes (native/mc.cpp through generate/marching_cubes.py)."""


def read(record):
    ms = record.get("host_spans", {}).get("grasp.mc")
    return sum(ms) / len(ms) if ms else None
