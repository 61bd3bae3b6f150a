"""Device milliseconds a frame of the operations launched inside the
layer's spans (``rtbench/layers/dense.json``), innermost span first."""


def read(run):
    if not run.timeline.has_layer("dense"):
        return None
    return run.timeline.layer_ms("dense")
