"""The port's counterparts of the JAX package's ``projects``."""
