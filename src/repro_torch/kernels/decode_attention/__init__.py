"""Split-KV decode attention kernel."""
