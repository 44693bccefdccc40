"""The benchmark's own counts of work (FLOPs and bytes of a step and of a
kernel call) and the chip's peaks, frozen here so that a change to the
program cannot move the yardstick."""
