"""Device milliseconds a frame of the sparse engine's select kernel K2
(``csrc/select_nearest.cu``): the traced frames' kernels named
``select_kernel`` (the single-chunk path) or ``select_chunks_kernel`` (the
boxes streamed in chunks), whatever layer launched them; None where no
frame ran one."""

import re

K2 = re.compile(r"\bselect_(chunks_)?kernel<")


def read(run):
    ms = [o[2] for o in run.timeline.ops
          if o[1] == "kernel" and o[3] is not None and not o[5]
          and K2.search(o[0])]
    if not ms:
        return None
    return sum(ms) / 1e3 / run.timeline.n_frames
