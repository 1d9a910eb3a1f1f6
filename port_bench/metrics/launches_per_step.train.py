"""launches_per_step.train: the kernels the profiler saw in the profiled
block of steps (copies and fills left out), per step."""


def read(record):
    prof = record.get("profile")
    n = record.get("profiled_steps")
    if record.get("family") != "train" or prof is None or not n:
        return None
    return prof.n_kernels / n
