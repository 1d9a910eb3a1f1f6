"""k2_cimg_roofline: K2 with fingertip c_img rows (csrc/trunk.cu's
trunk_kernel) in the profiled block: the least time of the work its
inputs need (harness/work.py: the chain over every nx^3 point and the
c_img product on the rows a touching fingertip gates, counted by the
reference's gates for each profiled grasp) over the kernel time the
profiler read by name."""

from port_bench.harness.work import k2_cimg_work, roofline_pct

KERNEL = "trunk_kernel"


def read(record):
    prof = record.get("profile")
    if prof is None or record.get("gating") != "tips":
        return None
    seconds, launches = prof.kernel_s(KERNEL)
    rows = record.get("gated_rows") or {}
    if launches == 0 or launches != len(record["profiled"]) or not rows:
        return None
    d = record["decoder"]
    flops = nbytes = 0
    for gid in record["profiled"]:
        f, b = k2_cimg_work(record["nx"] ** 3, rows[gid], d["hidden"], d["c_dim"],
                            d["n_blocks"], d["c_dim"])
        flops += f
        nbytes += b
    return roofline_pct(flops, nbytes, seconds)
