"""Utilities: carrying weights across from the JAX package."""
