"""Launchers of the port: ``train`` (the fault-tolerant train loop, COAX
curation, checkpoints) and ``serve`` (the COAX-routed serving launcher,
restoring the trainer's checkpoints)."""
