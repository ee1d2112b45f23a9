"""Model definitions of the port (inference only)."""
