"""Model configs of the dense LM family the port serves (see registry)."""
