"""k1_roofline: K1 (csrc/trunk.cu's trunk_kernel, contact-gated) in the
profiled block: the least time of the work its inputs need
(harness/work.py: the chain over every nx^3 point, per request) over the
kernel time the profiler read by name."""

from port_bench.harness.work import k1_work, roofline_pct

KERNEL = "trunk_kernel"


def read(record):
    prof = record.get("profile")
    if prof is None or record.get("gating") != "contact":
        return None
    seconds, launches = prof.kernel_s(KERNEL)
    if launches == 0:
        return None
    d = record["decoder"]
    flops, nbytes = k1_work(record["nx"] ** 3, d["hidden"], d["c_dim"], d["n_blocks"])
    return roofline_pct(launches * flops, launches * nbytes, seconds)
