"""Small utilities of the port (the parameter-tree helpers of the trainer)."""
