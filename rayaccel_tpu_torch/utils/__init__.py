"""The app shell's helpers: image output, render statistics, checkpoints,
stage profiling and the live viewer."""
