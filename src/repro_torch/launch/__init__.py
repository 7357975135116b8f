"""Entry points: the online query service driven by the load generator."""
