"""Fault tolerance for the training loop (`fault`): the restart manager
and the straggler watchdog."""
