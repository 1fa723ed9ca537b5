"""Parameter conversion and initialisation helpers of the port."""
