"""Flash attention forward kernel."""
