"""Noise schedules and the UniPC sampler of the port."""
