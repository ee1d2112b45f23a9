"""Serving layer of the port: the frozen RecSys engine and its hot caches."""
