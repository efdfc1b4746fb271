"""Fault tolerance for the training loop (`fault`: the restart manager
and the straggler watchdog) and error-feedback int8 compression
(`compression`)."""
