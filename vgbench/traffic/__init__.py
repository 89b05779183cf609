"""Traffic drivers, one file each, found by the `driver` name in a cell's
workload file.  A driver module's make(env) returns an object with
warmup_frames(), frame(k, span) (the program's frame k: its image on the
card), check_always() (window frames the check holds besides the first
and the seeded sample: the traffic's edge cases), reference(k) (the reference recorder's ops of the same frame:
(ops, width, height, images)), profiler (the program's FrameProfiler or
None) and close()."""
