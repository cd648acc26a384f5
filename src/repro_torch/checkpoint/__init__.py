"""Checkpoint store of the port (``ckpt.CheckpointManager``), the one
``faults.snapshot.SnapshotManager`` rides on."""
