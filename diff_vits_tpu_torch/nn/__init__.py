"""Building blocks of the port: channel-last [B, T, C] modules."""
