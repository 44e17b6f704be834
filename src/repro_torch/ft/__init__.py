"""Fault tolerance on the host: scripted crashes, heartbeat failure
detection and the straggler rule behind speculative re-lease."""
