"""Symbol tables (a copy of the JAX package's, for ``n_vocab``)."""
