"""Training steps."""
