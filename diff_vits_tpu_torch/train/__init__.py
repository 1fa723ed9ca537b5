"""Training step, optimizer, EMA and checkpoints of the port."""
