"""Device ms per frame in the big-scene route's kernels: the
hierarchical mask (``ray_mask_hier_kernel``) and the any-hit shadows
(``any_kernel``).  None where the stretch holds no frame or neither
kernel ran."""

import re

ROUTE = re.compile(r"\b(ray_mask_hier_kernel|any_kernel)\b")


def read(trace):
    units = trace.units("frame")
    ns = sum(e - s for n, s, e in trace.device_in_window() if ROUTE.search(n))
    if not units or not ns:
        return None
    return ns / 1e6 / units
