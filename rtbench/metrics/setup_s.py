"""Seconds from the start of the harness to the start of the window:
imports, the scene, the kernel library, the renderer, warm-up frames."""


def read(run):
    return run.setup_s
